"""Command-R+ 104B — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-plus]."""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 16

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    d_model=12_288,
    vocab_size=256_000,
    blocks=(BlockGroup(("attn",), 64),),
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    dtype=torch.bfloat16,
    source="hf:CohereForAI/c4ai-command-r-v01 (plus variant)",
)
