"""Mamba-2 780M — attention-free SSM stack via SSD [arXiv:2405.21060]."""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 1

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    d_model=1536,
    vocab_size=50_280,
    blocks=(BlockGroup(("mamba",), 48),),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_n_groups=1,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="arXiv:2405.21060 (Mamba-2 / SSD)",
)
