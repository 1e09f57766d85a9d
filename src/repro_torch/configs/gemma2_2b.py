"""Gemma-2B-shaped proxy, the paper's measurement model
[arXiv:2403.08295] — the reference config's exact values."""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 1

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    d_model=2048,
    vocab_size=256_000,
    blocks=(BlockGroup(("attn",), 18),),
    n_heads=8,
    n_kv_heads=1,            # MQA
    head_dim=256,
    d_ff=16_384,
    ffn_activation="gelu",
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="arXiv:2403.08295 (Gemma 2B)",
)
