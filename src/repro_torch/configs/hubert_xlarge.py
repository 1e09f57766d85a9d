"""HuBERT X-Large — encoder-only audio backbone [arXiv:2106.07447], the
reference config's exact values.

The conv/mel front end is a stub, as in the reference:
``prefix_only=True`` means the inputs are precomputed frame embeddings
(B, S, d), and the model is the bidirectional transformer encoder
predicting cluster ids (vocab 504, untied head; the token table is kept
and never read).  As in the reference, rotary positions stand in for
wav2vec2's conv positional embeddings and the FFN is the gated form.
There is no decode step (encoder-only): ``serve.Engine`` refuses it.
1.2597 B parameters, 2.52 GB in bf16.
"""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 2

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    d_model=1280,
    vocab_size=504,
    blocks=(BlockGroup(("attn",), 48),),
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    causal=False,            # bidirectional encoder
    prefix_only=True,        # frame embeddings in, no token embedding
    ffn_activation="gelu",
    dtype=torch.bfloat16,
    source="arXiv:2106.07447 (HuBERT)",
)
