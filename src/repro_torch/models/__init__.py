"""Dense attention transformer (port of ``repro.models``; the ``attn``
and ``local`` block kinds)."""
from .common import BlockGroup, ModelConfig
from .transformer import (decode_step, forward, init_caches, model_init,
                          param_count, prefill)

__all__ = ["BlockGroup", "ModelConfig", "model_init", "forward",
           "init_caches", "prefill", "decode_step", "param_count"]
