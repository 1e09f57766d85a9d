"""The model zoo's layer stacks (port of ``repro.models``): GQA and MLA
attention with dense and MoE FFNs (``models.moe`` for the experts and
their compressed expert-parallel dispatch), and the recurrent RG-LRU
(``models.rglru``) and Mamba-2 (``models.ssm``) block kinds."""
from .common import BlockGroup, ModelConfig
from .transformer import (decode_step, forward, forward_train, init_caches,
                          model_init, param_count, prefill)

__all__ = ["BlockGroup", "ModelConfig", "model_init", "forward",
           "forward_train", "init_caches", "prefill", "decode_step",
           "param_count"]
