"""Attention transformer with dense and MoE FFNs (port of
``repro.models``; the ``attn``, ``local``, ``attn_moe`` and
``local_moe`` block kinds, ``models.moe`` for the experts and their
compressed expert-parallel dispatch)."""
from .common import BlockGroup, ModelConfig
from .transformer import (decode_step, forward, forward_train, init_caches,
                          model_init, param_count, prefill)

__all__ = ["BlockGroup", "ModelConfig", "model_init", "forward",
           "forward_train", "init_caches", "prefill", "decode_step",
           "param_count"]
