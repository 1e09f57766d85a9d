"""DeepSeek-V3 671B — MLA + 256-expert top-8 MoE with one shared expert
[arXiv:2412.19437].  61 layers: a 3-layer dense-FFN prefix, then 58 MoE.

The reference's config values: MLA dims from the paper (q_lora 1536,
kv_lora 512, 128 nope + 64 rope a head, v 128), the dense prefix's d_ff
18 432, routed experts' d_ff 2048, softmax top-8 routing.  At full width
one H100 holds one layer of each group (``chip_smoke.py``).
"""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 16

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    d_model=7168,
    vocab_size=129_280,
    blocks=(BlockGroup(("mla",), 3),          # dense prefix
            BlockGroup(("mla_moe",), 58)),
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18_432,             # dense-prefix FFN
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    capacity_factor=1.25,
    dtype=torch.bfloat16,
    source="arXiv:2412.19437 (DeepSeek-V3)",
)
