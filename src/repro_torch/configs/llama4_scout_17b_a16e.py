"""Llama-4 Scout 17B-A16E — 16-expert top-1 MoE with shared expert,
early fusion [hf:meta-llama/Llama-4-Scout-17B-16E].

Every layer is MoE (interleave step 1); the reference's config values.
One H100 holds 4 of the 48 layers at full width (``chip_smoke.py``).
"""
import torch

from ..models.common import BlockGroup, ModelConfig

TRAIN_GRAD_ACCUM = 8

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    arch_type="moe",
    d_model=5120,
    vocab_size=202_048,
    blocks=(BlockGroup(("attn_moe",), 48),),
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    n_experts=16,
    experts_per_token=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    capacity_factor=1.5,     # top-1 routing needs more slack
    rope_theta=500_000.0,
    dtype=torch.bfloat16,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
