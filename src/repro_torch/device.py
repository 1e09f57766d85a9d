"""Device resolution shared by every entry point of the port, and the
one host copy a step's metrics take."""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "metrics_to_host"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Asking for CUDA (explicitly or by default) where there is
    none raises instead of carrying on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device and none is "
            "available; pass device='cpu' to run the plain-torch versions")
    return dev


def metrics_to_host(metrics: Mapping[str, torch.Tensor]
                    ) -> Dict[str, Union[float, np.ndarray]]:
    """A step's metric tensors (one device) on the host in one copy —
    the step's one sync: 0-d tensors as Python floats, the rest as
    float64 numpy arrays (histogram counts are exact there)."""
    keys = list(metrics)
    flat = torch.cat([metrics[k].detach().reshape(-1).to(torch.float64)
                      for k in keys]).cpu().numpy()
    out, at = {}, 0
    for k in keys:
        t = metrics[k]
        n = t.numel()
        out[k] = float(flat[at]) if t.dim() == 0 else flat[at:at + n].reshape(
            tuple(t.shape))
        at += n
    return out
