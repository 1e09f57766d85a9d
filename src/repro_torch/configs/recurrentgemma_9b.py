"""RecurrentGemma-9B — RG-LRU + local attention hybrid, 1 attn : 2 rec
[arXiv:2402.19427].  38 layers = 12 × (rec, rec, local-attn) + 2 rec."""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 4

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    d_model=4096,
    vocab_size=256_000,
    blocks=(BlockGroup(("rec", "rec", "local"), 12),
            BlockGroup(("rec", "rec"), 1)),
    n_heads=16,
    n_kv_heads=1,            # MQA for the local-attention layers
    head_dim=256,
    d_ff=12_288,
    lru_width=4096,
    conv_width=4,
    sliding_window=2048,     # local attention window
    logit_softcap=30.0,
    dtype=torch.bfloat16,
    source="arXiv:2402.19427 (RecurrentGemma / Griffin)",
)
