"""CodeQwen1.5-7B — dense, MHA (kv == heads) [hf:Qwen/CodeQwen1.5-7B]."""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 4

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    arch_type="dense",
    d_model=4096,
    vocab_size=92_416,
    blocks=(BlockGroup(("attn",), 32),),
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13_440,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    source="hf:Qwen/CodeQwen1.5-7B",
)
