"""InternVL2-26B — InternViT vision encoder + InternLM2-20B-style decoder
[arXiv:2404.16821], the reference config's exact values.

The vision tower and MLP projector are a stub, as in the reference: the
decoder takes ``prefix_len`` precomputed patch embeddings (an
early-fusion prefix) before the text tokens.  The language decoder is
the backbone: 48 layers, d 6144, 48 heads GQA kv 8, d_ff 16 384, vocab
92 553, untied head — 19.861 B parameters, 39.72 GB in bf16.
"""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 8

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    d_model=6144,
    vocab_size=92_553,
    blocks=(BlockGroup(("attn",), 48),),
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    prefix_len=1024,         # InternViT patch tokens after pixel-shuffle
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    source="arXiv:2404.16821 (InternVL2)",
)
