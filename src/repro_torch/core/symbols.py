"""Tensor → symbol-stream extraction (port of ``repro.core.symbols``) for
every dtype the paper analyzes: bfloat16, float32, e4m3, e5m2 and the
sub-byte e3m2, e2m3 and e2m1.

The paper codes 8-bit symbols.  A bfloat16 tensor splits into two byte
planes: the high byte (sign, exponent, top mantissa bit) is structured
and compresses hard, the low byte (mantissa) is near uniform, so each
plane keeps its own book.  A float32 tensor is four byte planes
(``b0`` the least significant); an fp8 tensor is one plane of its raw
bytes.

Byte handling goes through torch views (``view(torch.int16)``,
``view(torch.uint8)``), so it runs the same on the CPU and the card and
needs no ``ml_dtypes``.  Shifts are done on int16 and masked, because
unsigned 16-bit shifts are missing from CPU torch.

Every cast goes through ``xla_cast``, which gives the bytes XLA's
conversion gives the reference where torch's differs: a NaN cast to
bfloat16 is 0x7FC0 with its sign, where CPU torch writes 0xFFFF;
float8_e4m3fn has no infinity, and a magnitude past 464 (which rounds
beyond 448) or an infinity is NaN with its sign, where torch saturates
to ±448; a float8_e5m2 NaN is 0x7E with its sign, where torch writes
0x7F.  The wire (``comm.wire``) and the KV caches cast through it too.

Sub-byte formats (e3m2, e2m3, e2m1: OCP MX-style, no inf or NaN) are
emulated by nearest-value quantization onto the format's values, from
the reference's numpy tables (``exmy_values``); the symbol is the
format's code word and ``symbol_bits`` its true width.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["SymbolScheme", "SCHEMES", "scheme_for_dtype", "xla_cast",
           "bf16_planes", "bf16_planes_np", "bf16_bits_np",
           "bf16_from_planes", "f32_planes", "e4m3_planes", "e5m2_planes",
           "exmy_values", "exmy_quantize", "exmy_dequantize"]


def xla_cast(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``v`` cast to ``dtype`` as XLA converts (round to nearest even),
    where torch's own conversion differs: to bfloat16 a NaN is 0x7FC0
    with its sign; to float8_e4m3fn a magnitude past 464 (which rounds
    beyond 448), an infinity or a NaN is NaN (0x7F) with its sign; to
    float8_e5m2 a NaN is 0x7E with its sign.  bf16 and float32 inputs
    reach float32 exactly on the way to a float8."""
    if v.dtype == dtype:
        return v
    if dtype == torch.bfloat16:
        nan = torch.where(torch.signbit(v), -64, 0x7FC0).to(torch.int16)
        return torch.where(torch.isnan(v), nan,
                           v.to(dtype).view(torch.int16)).view(dtype)
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        v = v.to(torch.float32)
        r = v.to(dtype).view(torch.uint8)
        sign = torch.signbit(v).to(torch.uint8) << 7
        if dtype == torch.float8_e4m3fn:
            return torch.where(v.abs() <= 464, r, sign | 0x7F).view(dtype)
        return torch.where(torch.isnan(v), sign | 0x7E, r).view(dtype)
    return v.to(dtype)


def bf16_planes(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Split a tensor (cast to bfloat16 by ``xla_cast``) into low/high
    uint8 byte planes."""
    v = xla_cast(x.reshape(-1), torch.bfloat16).view(torch.int16)
    return {"lo": (v & 0xFF).to(torch.uint8),
            "hi": ((v >> 8) & 0xFF).to(torch.uint8)}


def bf16_bits_np(x) -> np.ndarray:
    """The bfloat16 bit patterns (uint16) of a float array, on the host
    and without ``ml_dtypes``, as ``ml_dtypes`` gives them
    (``astype(jnp.bfloat16)``, the reference's cast of a numpy array):
    a float64 is rounded to float32 and that to bfloat16, each to
    nearest even (rounding float64 once differs on ~1 value in 65 536
    of N(0, 1) draws).  A NaN is 0x7FC0 with its sign."""
    with np.errstate(over="ignore"):        # past float32: inf
        f = np.asarray(x).reshape(-1).astype(np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.where(np.signbit(f), 0xFFC0, 0x7FC0).astype(np.uint16)
    return np.where(np.isnan(f), nan, r)


def bf16_planes_np(x) -> Dict[str, np.ndarray]:
    """Low/high uint8 byte planes of a float array rounded to bfloat16
    by ``bf16_bits_np`` (the reference's ``bf16_planes_np``, on the host,
    without ``ml_dtypes``)."""
    u16 = bf16_bits_np(x)
    return {"lo": (u16 & 0xFF).astype(np.uint8),
            "hi": (u16 >> 8).astype(np.uint8)}


def bf16_from_planes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The inverse of ``bf16_planes``: symbols of the two planes (any
    integer dtype, values < 256, one shape) → the bfloat16 values
    ``lo | hi << 8``, bit for bit."""
    u = lo.to(torch.int32) | (hi.to(torch.int32) << 8)
    return torch.where(u >= 1 << 15, u - (1 << 16), u).to(
        torch.int16).view(torch.bfloat16)


def f32_planes(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The four little-endian bytes of a tensor cast to float32, as
    planes ``b0`` (least significant) to ``b3``."""
    b = x.to(torch.float32).reshape(-1).view(torch.uint8).reshape(-1, 4)
    return {f"b{i}": b[:, i].contiguous() for i in range(4)}


def e4m3_planes(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raw bytes of a tensor cast to float8_e4m3fn by ``xla_cast``,
    as one plane."""
    return {"b0": xla_cast(x.reshape(-1), torch.float8_e4m3fn).view(
        torch.uint8)}


def e5m2_planes(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raw bytes of a tensor cast to float8_e5m2 by ``xla_cast``, as
    one plane."""
    return {"b0": xla_cast(x.reshape(-1), torch.float8_e5m2).view(
        torch.uint8)}


# ------------------------------------------------------ eXmY (sub-byte)
def exmy_values(e: int, m: int) -> np.ndarray:
    """All representable values of a 1+e+m-bit (sign, exp, mantissa)
    format, in code order (index == code), as float64.

    MX-style semantics: exp field 0 → subnormal; no inf/nan (the whole
    code space is finite values)."""
    n = 1 << (1 + e + m)
    codes = np.arange(n, dtype=np.uint32)
    sign = np.where(codes >> (e + m) == 1, -1.0, 1.0)
    expf = (codes >> m) & ((1 << e) - 1)
    mant = codes & ((1 << m) - 1)
    bias = (1 << (e - 1)) - 1
    sub = expf == 0
    vals = np.where(
        sub,
        mant / (1 << m) * 2.0 ** (1 - bias),
        (1.0 + mant / (1 << m)) * 2.0 ** (expf.astype(np.float64) - bias),
    )
    return sign * vals


def _exmy_tables(e: int, m: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sorted values, code of each sorted rank, bin midpoints): a stable
    sort, so +0 (code 0) ranks before -0 and takes the zeros' bin."""
    vals = exmy_values(e, m)
    order = np.argsort(vals, kind="stable")
    sv = vals[order]
    mids = (sv[1:] + sv[:-1]) / 2.0
    return sv, order.astype(np.uint8), mids


def exmy_quantize(x: torch.Tensor, e: int, m: int) -> torch.Tensor:
    """Nearest-value quantization of ``x`` onto the eXmY code space, on
    x's device: the code words, (N,) uint8.  Values clip to the largest
    magnitude (MX casting); a tie takes the lower value; a NaN takes the
    code of the largest value, as the reference's ``np.searchsorted``
    sorts NaN last."""
    sv, codes, mids = _exmy_tables(e, m)
    dev = x.device
    xf = x.reshape(-1).to(torch.float64).clamp(float(sv[0]), float(sv[-1]))
    idx = torch.searchsorted(torch.from_numpy(mids).to(dev), xf)
    idx = torch.where(torch.isnan(xf), len(mids), idx)
    return torch.from_numpy(codes).to(dev)[idx]


def exmy_dequantize(sym: torch.Tensor, e: int, m: int) -> torch.Tensor:
    """Code words → their float64 values, on the codes' device."""
    vals = torch.from_numpy(exmy_values(e, m)).to(sym.device)
    return vals[sym.to(torch.int64)]


@dataclass(frozen=True)
class SymbolScheme:
    """How a tensor dtype maps to one or more uint8 symbol streams."""
    name: str
    planes: Tuple[str, ...]
    symbol_bits: int                      # true bits per symbol (≤8)
    n_symbols: int                        # alphabet size (≤256)
    to_symbols: Callable[[torch.Tensor], Dict[str, torch.Tensor]]

    def total_symbol_bits(self) -> int:
        """Bits of raw payload represented by one symbol from *each* plane."""
        return self.symbol_bits * len(self.planes)


SCHEMES: Dict[str, SymbolScheme] = {
    "bf16": SymbolScheme("bf16", ("lo", "hi"), 8, 256, bf16_planes),
    "f32": SymbolScheme("f32", ("b0", "b1", "b2", "b3"), 8, 256, f32_planes),
    "e4m3": SymbolScheme("e4m3", ("b0",), 8, 256, e4m3_planes),
    "e5m2": SymbolScheme("e5m2", ("b0",), 8, 256, e5m2_planes),
    "e3m2": SymbolScheme("e3m2", ("b0",), 6, 64,
                         lambda x: {"b0": exmy_quantize(x, 3, 2)}),
    "e2m3": SymbolScheme("e2m3", ("b0",), 6, 64,
                         lambda x: {"b0": exmy_quantize(x, 2, 3)}),
    "e2m1": SymbolScheme("e2m1", ("b0",), 4, 16,
                         lambda x: {"b0": exmy_quantize(x, 2, 1)}),
}

_DTYPE_SCHEMES = {torch.bfloat16: "bf16", torch.float32: "f32",
                  torch.float8_e4m3fn: "e4m3", torch.float8_e5m2: "e5m2"}


def scheme_for_dtype(dtype: torch.dtype) -> SymbolScheme:
    """The symbol scheme of a torch dtype (the reference maps the same
    four by name)."""
    if dtype not in _DTYPE_SCHEMES:
        raise KeyError(f"no symbol scheme for dtype {dtype}")
    return SCHEMES[_DTYPE_SCHEMES[dtype]]
