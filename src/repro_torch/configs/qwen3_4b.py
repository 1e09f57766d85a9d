"""Qwen3-4B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 2

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    d_model=2560,
    vocab_size=151_936,
    blocks=(BlockGroup(("attn",), 36),),
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="hf:Qwen/Qwen3-8B (4B sibling)",
)
