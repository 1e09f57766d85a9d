"""Plain pieces the reference models share: float32 matmuls (TF32 off),
an RMSNorm, the embedding scale, and the control's lower precision.

``Precision("float32")`` is the reference: every weight upcast from the
served bf16 and every product in float32.  ``Precision("fp8")`` is the
control, the model computed in the nearest precision below the
configuration's bf16: each matmul's two operands and its result rounded
to float8 e4m3 with a per-tensor scale (amax / 448), the products
accumulated in float32, the elementwise work (norms, activations, the
scan, the softmax) as the reference's.
"""
from __future__ import annotations

import contextlib
import math

import torch

_E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products stay float32 (no TF32) inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        if self.name == "float32":
            return t
        amax = t.abs().amax().clamp(min=1e-30)
        scale = _E4M3_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return self.operand(torch.einsum(eq, self.operand(a),
                                         self.operand(b)))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """x / rms(x) · (1 + scale), in float32."""
    x = x.to(torch.float32)
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + scale.to(torch.float32))


def embed_scale(d: int) -> float:
    """√d rounded to bfloat16, the factor the served model multiplies
    its input embeddings by."""
    return torch.tensor(math.sqrt(d), dtype=torch.bfloat16).item()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)
