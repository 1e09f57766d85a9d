"""Command-R 35B — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 8

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    d_model=8192,
    vocab_size=256_000,
    blocks=(BlockGroup(("attn",), 40),),
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_528,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
