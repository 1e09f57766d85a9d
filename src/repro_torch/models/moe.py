"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing,
streaming-capacity dispatch, shared experts, and the expert-parallel
path whose dispatch and combine ride the compressed ring all-to-all.

Capacity is streaming (causal), as in the reference: token ``t`` of a
sequence is dropped from expert ``e`` iff the assignments to ``e`` from
tokens ``≤ t`` of the same sequence exceed ``moe_stream_capacity(t+1)``,
so ``moe_decode`` (which carries a per-(sequence, expert) count in its
cache) drops exactly the slots the full forward drops.

Layout: each sequence's kept slots fill an ``(E, C, d)`` buffer; the
experts run over every sequence's buffer at once, one product per
expert with ``Z·C`` rows (``_experts``).  The expert-parallel path
(``moe_apply_a2a``) gives each expert the same ``Z·C`` rows in the same
order, through the same call, so its result is the scatter path's bit
for bit.  Dispatch and combine are gathers (a dropped slot reads a zero
row), and the k slots of a token add in slot order, never by atomics.

The router runs in float32 with the Switch load-balance loss.  The
compressed wire's codec is process-global configuration
(``configure_a2a_wire``), folded into the lifecycle's epoch fingerprint
(``a2a_wire_fingerprint``).  ``moe_apply_eshard`` is the reference's
expert-sharded path (``moe_impl="eshard"``): each "model" rank runs its
local experts over its data shard's tokens at a batch-global capacity,
and a psum over "model" combines.

Both mesh paths (``moe_apply_a2a_block``, ``moe_apply_eshard``) run on
a mesh of loopback axes (``comm.loopback_mesh``: every rank stacked in
one process, the block splitting the global batch over them and joining
it back) or of process-group axes (``comm.process_group_mesh``: one
rank a process, which holds its own rows, as under the reference's
``shard_map``).

Gradients on a process-group mesh.  A process's loss is its own rows'
loss, and the global loss's gradient (the loopback mesh's on the whole
batch) is the mean of the processes' gradients over the axes that split
the rows: the data axes under eshard, whose "model" ranks hold the same
rows, and every axis under a2a, whose "model" axis splits them too.  So
a pmean over an axis that splits the rows passes the cotangent back
whole (the mean of the gradients divides, ``_pmean``).  Under eshard,
the exit psum over "model" hands each rank's partial output the whole
cotangent (``_psum``), and the routed input and the router enter
through a psum of the ranks' cotangents (``_replicated_in``, Megatron's
f, ``shard_map``'s transpose of an input replicated over "model"), so
every "model" rank holds the whole gradient of each replicated leaf and
its own experts' part of the expert leaves.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import (Axes, ModelConfig, PSpec, shard_or_replicate,
                     truncated_normal_init)
from .layers import decode_pos, mlp_apply, mlp_init, mlp_pspec

__all__ = ["moe_init", "moe_pspec", "moe_apply", "moe_prefill", "moe_decode",
           "moe_apply_a2a", "moe_apply_a2a_block", "moe_apply_eshard",
           "configure_a2a_wire", "a2a_wire_fingerprint", "use_mesh",
           "current_mesh", "moe_capacity", "moe_stream_capacity",
           "moe_stream_capacity_host"]


# ------------------------------------------------------------- capacity
def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts
                    * cfg.capacity_factor)
    return max(4, -(-cap // 4) * 4)          # round up to a multiple of 4


def moe_stream_capacity(n_tokens, cfg: ModelConfig) -> torch.Tensor:
    """Causal capacity threshold after the first ``n_tokens`` tokens, as
    int32 (``n_tokens`` an int or a tensor; the result lies on its
    device).  The float32 op order is ``moe_stream_capacity_host``'s, so
    both give the reference's integers."""
    t = torch.as_tensor(n_tokens).to(torch.float32)
    # the constants are filled in on the device, not copied from the
    # host: a decode step captured in a CUDA graph computes this
    f = torch.full((), cfg.experts_per_token / cfg.n_experts,
                   dtype=torch.float32, device=t.device)
    cf = torch.full((), cfg.capacity_factor, dtype=torch.float32,
                    device=t.device)
    c = torch.ceil(t * f * cf).to(torch.int32)
    return torch.clamp(((c + 3) // 4) * 4, min=4)


def moe_stream_capacity_host(n_tokens: int, cfg: ModelConfig) -> int:
    """Host mirror of ``moe_stream_capacity`` (static buffer sizing)."""
    t = np.float32(n_tokens)
    c = int(np.ceil(t * np.float32(cfg.experts_per_token / cfg.n_experts)
                    * np.float32(cfg.capacity_factor)))
    return max(4, ((c + 3) // 4) * 4)


# ----------------------------------------------------------------- init
def moe_init(cfg: ModelConfig, generator, device):
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff

    def w(shape, dtype, scale):
        return truncated_normal_init(shape, dtype, scale, generator, device)

    p = {"router": w((d, e), torch.float32, d ** -0.5),
         "w_gate": w((e, d, ff), cfg.dtype, d ** -0.5),
         "w_up": w((e, d, ff), cfg.dtype, d ** -0.5),
         "w_down": w((e, ff, d), cfg.dtype, ff ** -0.5)}
    if cfg.n_shared_experts > 0:
        p["shared"] = mlp_init(cfg, generator, device,
                               d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


# -------------------------------------------------------------- routing
def moe_pspec(cfg: ModelConfig, axes: Axes):
    me = shard_or_replicate(cfg.n_experts, axes)
    p = {"router": PSpec(None, None), "w_gate": PSpec(me, None, None),
         "w_up": PSpec(me, None, None), "w_down": PSpec(me, None, None)}
    if cfg.n_shared_experts > 0:
        p["shared"] = mlp_pspec(cfg, axes,
                                d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return p


def _route_probs(params, xf, cfg: ModelConfig):
    """Router in float32: (N, d) → (topw, topi, probs)."""
    logits = xf.to(torch.float32) @ params["router"]            # (N, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, cfg.experts_per_token, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return topw, topi, probs


def _aux(topi, probs, cfg: ModelConfig):
    """Switch load-balance loss of each row group: topi (..., N, k),
    probs (..., N, E) → (...) float32.  ``frac_routed`` adds 1/(N·k) once
    a slot, as the reference's scatter-add does (equal addends: the
    order does not change the sum)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    n = topi.shape[-2]
    lead = topi.shape[:-2]
    idx = topi.reshape(-1, n * k)
    one = torch.full(idx.shape, 1.0 / (n * k), dtype=torch.float32,
                     device=idx.device)
    frac = torch.zeros((idx.shape[0], e), dtype=torch.float32,
                       device=idx.device).scatter_add_(1, idx, one)
    mean = probs.reshape(-1, n, e).mean(1)
    aux = torch.sum(frac * mean, dim=-1) * (cfg.router_aux_weight * e)
    return aux.reshape(lead)


def _route(params, xf, cfg: ModelConfig):
    """(N, d) → (topw, topi, aux_loss), the reference's ``_route``."""
    topw, topi, probs = _route_probs(params, xf, cfg)
    return topw, topi, _aux(topi, probs, cfg)


# ------------------------------------------------------ dispatch/combine
def _slot_thresholds(s: int, cfg: ModelConfig, device) -> torch.Tensor:
    """The causal capacity of each routing slot of an S-token sequence."""
    thr = moe_stream_capacity(torch.arange(1, s + 1, device=device), cfg)
    return thr.repeat_interleave(cfg.experts_per_token)


def _dispatch(x, topi, cfg: ModelConfig, cap: int, thr=None):
    """Every sequence's streaming-capacity dispatch (or, given ``thr``,
    a fixed capacity: a slot is kept iff fewer than ``thr`` earlier
    slots of its row group went to its expert).

    x (Z, S, d), topi (Z, S, k) → (buf (Z, E, C, d), slot (Z, S·k)
    int64, counts (Z, E) int32).  ``slot`` is each routing slot's row in
    the flattened buffer, or ``Z·E·C`` (a zero row) when the slot is
    dropped; ``counts`` are the routed totals (kept and dropped), the
    state ``moe_decode`` continues from.  The buffer is a gather: a
    slot row is read by at most one buffer row, so the backward adds no
    two values into one place.
    """
    z, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    dev = x.device
    flat_e = topi.reshape(z, s * k)
    onehot = F.one_hot(flat_e, e).to(torch.int32)               # (Z, S·k, E)
    pos = torch.cumsum(onehot, dim=1).gather(2, flat_e[..., None])[..., 0] - 1
    keep = pos < (_slot_thresholds(s, cfg, dev) if thr is None else thr)
    base = torch.arange(z, device=dev)[:, None] * (e * cap)
    dump = z * e * cap
    slot = torch.where(keep, base + flat_e * cap + pos, dump)
    rows = x[:, :, None, :].expand(z, s, k, d).reshape(z * s * k, d)
    rows = torch.cat([rows, rows.new_zeros((1, d))])
    src = torch.full((dump + 1,), z * s * k, dtype=torch.int64, device=dev)
    src.scatter_(0, slot.reshape(-1),
                 torch.arange(z * s * k, device=dev))   # dump row: unread
    buf = rows.index_select(0, src[:dump]).reshape(z, e, cap, d)
    return buf, slot, onehot.sum(1, dtype=torch.int32)


def _combine(out_buf, slot, topw, s: int):
    """Inverse of ``_dispatch``: out_buf (Z, E, C, d), slot (Z, S·k),
    topw (Z, S, k) → (Z, S, d); a dropped slot adds zero, and a token's
    k slots add in slot order from zero (the reference's scatter-add)."""
    z, e, cap, d = out_buf.shape
    k = topw.shape[-1]
    rows = torch.cat([out_buf.reshape(z * e * cap, d),
                      out_buf.new_zeros((1, d))])
    yd = rows.index_select(0, slot.reshape(-1)).reshape(z, s, k, d)
    yd = yd * topw[..., None].to(out_buf.dtype)
    y = out_buf.new_zeros((z, s, d))
    for j in range(k):
        y = y + yd[:, :, j]
    return y


def _act(cfg: ModelConfig):
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.ffn_activation == "silu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


def _expert_weights(params):
    """(w_gate, w_up, w_down) of each expert: ``unbind`` views, so the
    backward stacks each weight's gradient once."""
    return list(zip(params["w_gate"].unbind(0), params["w_up"].unbind(0),
                    params["w_down"].unbind(0)))


def _experts(buf, weights, cfg: ModelConfig):
    """buf (Z, E', C, d) with ``weights`` the E' experts' (w_gate, w_up,
    w_down) → (Z, E', C, d): one gated-MLP product per expert over its
    Z·C rows.  Both MoE paths call this with the same rows per expert,
    so their products are the same calls."""
    z, _, c, d = buf.shape
    act = _act(cfg)
    outs = []
    for xj, (wg, wu, wd) in zip(buf.unbind(1), weights):
        xe = xj.reshape(z * c, d)
        h = act(xe @ wg) * (xe @ wu)
        outs.append((h @ wd).reshape(z, c, d))
    return torch.stack(outs, dim=1)


def _moe_forward(params, x, cfg: ModelConfig):
    """x (B, S, d) → (y (B, S, d), aux, counts (B, E) int32)."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    cap = moe_stream_capacity_host(s, cfg)
    xf = x.reshape(b * s, d)
    topw, topi, aux = _route(params, xf, cfg)
    buf, slot, counts = _dispatch(x, topi.reshape(b, s, k), cfg, cap)
    out_buf = _experts(buf, _expert_weights(params), cfg)
    y = _combine(out_buf, slot, topw.reshape(b, s, k), s).reshape(b * s, d)
    if cfg.n_shared_experts > 0:
        y = y + mlp_apply(params["shared"], xf, cfg)
    return y.reshape(b, s, d), aux, counts


def moe_apply(params, x, cfg: ModelConfig):
    """x: (B, S, d) → (y, aux_loss).  Routed top-k + optional shared
    expert."""
    y, aux, _ = _moe_forward(params, x, cfg)
    return y, aux


def moe_prefill(params, x, cfg: ModelConfig):
    """Full-sequence MoE that also returns the decode count cache:
    (y, aux, counts (B, E) int32)."""
    return _moe_forward(params, x, cfg)


def moe_decode(params, x, counts, pos, cfg: ModelConfig):
    """One-token MoE step reproducing the forward's streaming capacity.

    x (B, 1, d); counts (B, E) int32, the routed totals of tokens < pos,
    **updated in place** (kept and dropped slots both count); ``pos`` the
    token's absolute position, a 0-d int32 tensor on x's device (or an
    int).  A slot is dropped iff its expert's count has reached
    ``moe_stream_capacity(pos + 1)``, the forward's decision for token
    ``pos``, computed on the device as the reference computes it from
    its traced position.  Returns (y (B, 1, d), counts).
    """
    b, _, d = x.shape
    e = cfg.n_experts
    xf = x.reshape(b, d)
    topw, topi, _ = _route_probs(params, xf, cfg)               # (B, k)
    thr = moe_stream_capacity(decode_pos(pos, x.device) + 1, cfg)
    keep = counts.gather(1, topi) < thr                          # (B, k)
    # a row's k experts are distinct, so the scatter-add counts each
    # slot once
    counts.scatter_add_(1, topi, torch.ones_like(topi, dtype=counts.dtype))

    onehot = F.one_hot(topi, e).to(torch.float32)               # (B, k, E)
    sel = (onehot * keep[..., None].to(torch.float32)).to(xf.dtype)
    buf = torch.einsum("bke,bd->bed", sel, xf)                  # (B, E, d)
    out = _experts(buf[:, :, None], _expert_weights(params), cfg)[:, :, 0]
    we = torch.einsum("bke,bk->be", onehot, topw)               # (B, E) f32
    y = torch.einsum("bed,be->bd", out, we.to(xf.dtype))
    if cfg.n_shared_experts > 0:
        y = y + mlp_apply(params["shared"], xf, cfg)
    return y.reshape(b, 1, d), counts


# ------------------------------------------------------------ a2a wire
class _A2AWire(torch.autograd.Function):
    """``ring_all_to_all`` with an exact straight-through backward.

    The coded wire is value for value the plain all-to-all permutation,
    so its transpose is that permutation of the cotangent (the
    reference's custom VJP).  The ring's stats are written, detached,
    into ``out_stats``: a measurement, not a function to differentiate.
    """

    @staticmethod
    def forward(ctx, send, axis, books, scheme_name, chunk, backend,
                out_stats):
        from ..comm.ring import ring_all_to_all
        ctx.axis = axis
        recv, stats = ring_all_to_all(send, axis, books, scheme_name,
                                      chunk=chunk, decode_backend=backend)
        out_stats.update({k: v.detach() for k, v in stats.items()})
        return recv

    @staticmethod
    def backward(ctx, ct):
        return (_plain_all_to_all(ct, ctx.axis), None, None, None, None,
                None, None)


def _plain_all_to_all(x, axis):
    """The uncoded all-to-all on the coded ring's schedule: round t
    sends each rank's shard ``(i + t) % n`` through the rotation by t
    (``Axis.ppermute``: point-to-point, which moves bf16 on any
    backend)."""
    from ..comm.axis import put_rows, take_rows
    n, nl = axis.size, len(axis.batch)
    i = axis.index(x.device)
    out = put_rows(torch.zeros_like(x), i, take_rows(x, i, nl), nl)
    for t in range(1, n):
        got = axis.ppermute(take_rows(x, (i + t) % n, nl).contiguous(), t)
        out = put_rows(out, (i - t) % n, got, nl)
    return out


def _a2a_wire(send, axis, books, scheme_name: str, chunk: int,
              decode_backend: str):
    stats: Dict[str, torch.Tensor] = {}
    recv = _A2AWire.apply(send, axis, books, scheme_name, chunk,
                          decode_backend, stats)
    return recv, stats


def moe_apply_a2a(params, x, cfg: ModelConfig, axis, books, *,
                  scheme_name: str = "bf16", chunk: int = 2048,
                  decode_backend: str = "multisym"):
    """Expert-parallel MoE whose dispatch and combine ride the compressed
    ring all-to-all over ``axis`` (a ``comm.axis.Axis`` of size tp, with
    ``cfg.n_experts % tp == 0``); rank r owns experts ``[r·E/tp,
    (r+1)·E/tp)``.

    ``x`` is each rank's ``(B_local, S, d)`` token slab behind the
    axis's rank dims (``axis.batch``; none on a ``ProcessGroupAxis``),
    ``params`` the full MoE params.  Route and dispatch locally → ring
    all-to-all of the ``(E, C, d)`` buffers grouped by owning rank
    (coded) → each rank's experts over every rank's buffers → ring
    all-to-all back (coded) → combine locally.

    The wire is lossless, each expert gets the rows the scatter path
    gives it through the same call, and on a ``LoopbackAxis`` the
    per-token ops (router, shared expert) run over all ranks' rows at
    once, as ``moe_apply`` runs them over the global batch: so on one
    device the result is ``moe_apply``'s on the global batch bit for
    bit.  The aux loss is the mean of the per-rank Switch losses.

    Returns ``(y, aux, stats)``: the two all-to-alls' ledgers merged
    (``hop_coded_bits`` dispatch then combine, the other keys summed).
    Differentiable: the wire's backward is the plain permutation.
    """
    tp = axis.size
    e = cfg.n_experts
    if e % tp != 0:
        raise ValueError(f"n_experts={e} not divisible by axis "
                         f"{axis.name!r} size {tp}")
    e_local = e // tp
    lead = tuple(axis.batch)
    nl = len(lead)
    r = math.prod(lead)
    b, s, d = x.shape[nl:]
    k = cfg.experts_per_token
    cap = moe_stream_capacity_host(s, cfg)
    xf = x.reshape(r * b * s, d)

    topw, topi, probs = _route_probs(params, xf, cfg)
    aux_local = _aux(topi.reshape(*lead, b * s, k),
                     probs.reshape(*lead, b * s, e), cfg)
    aux = _pmean(aux_local, axis)
    buf, slot, _ = _dispatch(x.reshape(r * b, s, d),
                             topi.reshape(r * b, s, k), cfg, cap)

    # ---- dispatch wire: buffers grouped by the rank owning the expert
    send = buf.reshape(*lead, b, tp, e_local, cap, d).movedim(nl + 1, nl)
    recv, s_disp = _a2a_wire(send, axis, books, scheme_name, chunk,
                             decode_backend)
    hbuf = recv.reshape(r, tp * b, e_local, cap, d)  # every rank's tokens

    # ---- each rank's experts over every rank's buffers
    weights = _expert_weights(params)
    owners = axis.index(torch.device("cpu")).reshape(-1).tolist()
    out_loc = torch.stack([
        _experts(hb, weights[o * e_local:(o + 1) * e_local], cfg)
        for hb, o in zip(hbuf.unbind(0), owners)])

    # ---- combine wire: expert outputs return to their source ranks
    back, s_comb = _a2a_wire(out_loc.reshape(*lead, tp, b, e_local, cap, d),
                             axis, books, scheme_name, chunk, decode_backend)
    out_buf = back.movedim(nl, nl + 1).reshape(r * b, e, cap, d)
    y = _combine(out_buf, slot, topw.reshape(r * b, s, k), s)
    y = y.reshape(r * b * s, d)
    if cfg.n_shared_experts > 0:
        y = y + mlp_apply(params["shared"], xf, cfg)

    stats = {key: (torch.cat([s_disp[key], s_comb[key]], dim=-1)
                   if key == "hop_coded_bits" else s_disp[key] + s_comb[key])
             for key in s_disp}
    return y.reshape(x.shape), aux, stats


# ------------------------------------------------------------------ a2a
# Block-stack wiring for the compressed dispatch (``moe_impl="a2a"``).
# The wire codec is process-global configuration, not model state:
# fixed books come from earlier data (paper §4) and every replica must
# hold the same ones.  At bootstrap a deterministic activation-shaped
# sample stands in; deployments install real books (for example a
# lifecycle manager's) through ``configure_a2a_wire``.
_A2A_WIRE = {"books": None, "scheme_name": "bf16", "chunk": 512,
             "decode_backend": "auto"}
_A2A_DEFAULT_BOOKS: Dict[str, dict] = {}


def configure_a2a_wire(books=None, scheme_name: Optional[str] = None,
                       chunk: Optional[int] = None,
                       decode_backend: Optional[str] = None, *,
                       spec=None) -> None:
    """Set the codec the ``moe_impl="a2a"`` block path encodes with.

    Any argument left ``None`` keeps its current value; ``books`` maps
    plane → book for the configured scheme.  Or pass a bitexact
    ``CompressionSpec`` as ``spec``: the books are rebuilt from its
    per-plane canonical lengths through its codec (what every decoding
    peer holds), and scheme, chunk and decode backend follow it.

    The state is process-global, so ``a2a_wire_fingerprint`` folds it
    into the lifecycle's epoch fingerprint (``lifecycle.sync``): a
    half-configured fleet fails ``verify_epoch_agreement``.
    """
    if spec is not None:
        if books is not None:
            raise ValueError("pass either books or spec, not both")
        if spec.plane_lengths is None:
            raise ValueError("configure_a2a_wire(spec=...) needs a spec "
                             "with plane_lengths (mode != off)")
        from ..core.codec import get_codec
        codec = get_codec(spec.codec)
        books = {
            plane: codec.book_from_lengths(
                np.asarray(lens, np.int32),
                key=(spec.tensor_kind, spec.scheme_name, plane))
            for plane, lens in spec.plane_lengths}
        scheme_name = spec.scheme_name
        chunk = spec.chunk
        decode_backend = spec.decode_backend
    if books is not None:
        _A2A_WIRE["books"] = dict(books)
    if scheme_name is not None:
        _A2A_WIRE["scheme_name"] = scheme_name
    if chunk is not None:
        _A2A_WIRE["chunk"] = int(chunk)
    if decode_backend is not None:
        _A2A_WIRE["decode_backend"] = decode_backend


def a2a_wire_fingerprint() -> str:
    """Deterministic digest of the process-global a2a wire config (the
    reference's string, letter for letter): a constant while no books
    are configured, else a sha256 over the wire knobs and each plane's
    codec and code lengths."""
    if _A2A_WIRE["books"] is None:
        return "a2a:unconfigured"
    h = hashlib.sha256()
    h.update(f"{_A2A_WIRE['scheme_name']}|{_A2A_WIRE['chunk']}|"
             f"{_A2A_WIRE['decode_backend']}".encode())
    for plane in sorted(_A2A_WIRE["books"]):
        b = _A2A_WIRE["books"][plane]
        h.update(plane.encode() + b"\x1e")
        h.update(getattr(b, "codec_name", "huffman").encode() + b"\x1e")
        h.update(np.ascontiguousarray(b.lengths, np.int32).tobytes())
    return "a2a:" + h.hexdigest()


def bootstrap_sample() -> torch.Tensor:
    """The bootstrap books' sample: 65 536 N(0, 1) draws of
    ``numpy.random.default_rng(0)`` rounded to bf16 through float32, the
    reference's bits (its ``astype(bfloat16)`` rounds through float32)."""
    draws = np.random.default_rng(0).normal(0.0, 1.0, 1 << 16)
    return torch.from_numpy(draws).to(torch.float32).to(torch.bfloat16)


def _a2a_wire_books(scheme_name: str):
    if _A2A_WIRE["books"] is not None:
        return _A2A_WIRE["books"]
    if scheme_name not in _A2A_DEFAULT_BOOKS:
        from ..core.codebook import build_codebook
        from ..core.symbols import SCHEMES
        planes = SCHEMES[scheme_name].to_symbols(bootstrap_sample())
        _A2A_DEFAULT_BOOKS[scheme_name] = {
            p: build_codebook(np.bincount(s.numpy(), minlength=256),
                              key=("moe_dispatch", scheme_name, p))
            for p, s in planes.items()}
    return _A2A_DEFAULT_BOOKS[scheme_name]


# ------------------------------------------------------------- the mesh
_MESH: contextvars.ContextVar = contextvars.ContextVar("moe_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mapping[str, object]]):
    """What the reference's ``with mesh:`` is: the mesh the block stack
    sees, a mapping of axis names to ``comm.axis`` axes (for example
    ``comm.loopback_mesh({"data": 2, "model": 2})``).  The previous mesh
    comes back on exit."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[Mapping[str, object]]:
    """The mesh of the innermost ``use_mesh``, or None."""
    return _MESH.get()


def _on_processes(mesh, what: str) -> bool:
    """True for a mesh of ``ProcessGroupAxis``, False for one of
    ``LoopbackAxis``; a mesh that mixes them raises."""
    from ..comm.axis import LoopbackAxis, ProcessGroupAxis
    axes = list(mesh.values())
    if all(isinstance(a, ProcessGroupAxis) for a in axes):
        return True
    if all(isinstance(a, LoopbackAxis) for a in axes):
        return False
    raise NotImplementedError(
        f"{what} runs on a mesh of loopback axes or one of process-group "
        f"axes, not on a mesh that mixes them")


class _ReplicatedPsum(torch.autograd.Function):
    """``axis.psum`` over a process group whose ranks each go on with the
    sum as one replicated value: a rank's part enters that value with
    weight 1, so its cotangent is the value's (what each rank's part
    gets on a loopback mesh, where one replica of the sum is read)."""

    @staticmethod
    def forward(ctx, t, axis):
        return axis.psum(t)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _RowMean(torch.autograd.Function):
    """``axis.psum / size`` over a process group whose ranks hold
    different rows: the cotangent goes back whole, since the mean of the
    processes' gradients over the axis divides it."""

    @staticmethod
    def forward(ctx, t, axis):
        return axis.psum(t) / axis.size

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _ReplicatedIn(torch.autograd.Function):
    """The identity on a value every rank of ``axis`` holds and feeds
    into its own part of a sum over ``axis``; the backward adds the
    ranks' cotangents, each of which saw only its own part."""

    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, ct):
        return ctx.axis.psum(ct.contiguous()), None


def _on_group(axis) -> bool:
    from ..comm.axis import ProcessGroupAxis
    return isinstance(axis, ProcessGroupAxis)


def _psum(t, axis):
    """``axis.psum(t)`` of partial values, differentiable on a
    process-group axis too."""
    return _ReplicatedPsum.apply(t, axis) if _on_group(axis) \
        else axis.psum(t)


def _pmean(t, axis):
    """The mean of ``t`` over ``axis``, whose ranks hold different rows."""
    return _RowMean.apply(t, axis) if _on_group(axis) \
        else axis.psum(t) / axis.size


def _replicated_in(t, axis):
    """``t``, which every rank of the process-group ``axis`` holds,
    entering work whose parts ``_psum`` adds over ``axis``."""
    return _ReplicatedIn.apply(t, axis) if _on_group(axis) else t


def _split_batch(x, mesh, batch_axes):
    """(B, ...) → the loopback mesh's rank dims + (B / ranks, ...): the
    batch split over ``batch_axes`` in that order, the last minor (the
    reference's ``P(batch_axes)``), laid out in the mesh's dim order."""
    sizes = [mesh[a].size for a in batch_axes]
    dims = [mesh[a].dim for a in batch_axes]
    nb = x.shape[0] // math.prod(sizes)
    split = x.reshape(*sizes, nb, *x.shape[1:])
    order = sorted(range(len(dims)), key=lambda i: dims[i])
    return split.permute(*order, *range(len(dims), split.dim())), order


def _join_batch(y, order):
    inv = [order.index(i) for i in range(len(order))]
    joined = y.permute(*inv, *range(len(order), y.dim()))
    return joined.reshape(-1, *y.shape[len(order) + 1:])


def moe_apply_a2a_block(params, x, cfg: ModelConfig, mesh=None):
    """``moe_impl="a2a"``: the compressed-dispatch MoE inside the block
    stack.

    ``mesh`` (default: ``current_mesh()``) must hold a ``"model"`` axis
    whose size divides ``n_experts``; tokens split over every axis
    (``"model"`` minor), experts over ``"model"``.  Anything else falls
    back to the scatter path: the same numbers, no wire.  On loopback
    axes (``comm.loopback_mesh``) ``x`` is the global batch, which the
    block splits over the ranks and joins back (the global batch must
    divide by the ranks, else the fallback); on process-group axes
    (``comm.process_group_mesh``) ``x`` is this process's rows and
    ``y`` its rows' output.

    Returns ``(y, aux, wire_coded_bits)``: the measured global coded
    bits of this layer's dispatch and combine (float64), which
    ``forward_train`` sums into ``moe_wire_coded_bits``.
    """
    mesh = current_mesh() if mesh is None else mesh
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    if not mesh or "model" not in mesh:
        y, aux = moe_apply(params, x, cfg)
        return y, aux, zero
    on_processes = _on_processes(mesh, "moe_apply_a2a_block")
    tp = mesh["model"].size
    data_axes = tuple(a for a in mesh if a != "model")
    dp = math.prod(mesh[a].size for a in data_axes)
    if tp == 1 or cfg.n_experts % tp != 0 or (
            not on_processes and x.shape[0] % (dp * tp) != 0):
        y, aux = moe_apply(params, x, cfg)
        return y, aux, zero

    wire = _A2A_WIRE
    books = _a2a_wire_books(wire["scheme_name"])
    xs, order = (x, None) if on_processes else _split_batch(
        x, mesh, data_axes + ("model",))
    y, aux, stats = moe_apply_a2a(
        params, xs, cfg, mesh["model"], books,
        scheme_name=wire["scheme_name"], chunk=wire["chunk"],
        decode_backend=wire["decode_backend"])
    # stats are global/n on every rank: the psum over the a2a axis is one
    # data group's total; data groups ran their own a2as, so they add
    coded = mesh["model"].psum(stats["coded_wire_bits"])
    for a in data_axes:
        aux = _pmean(aux, mesh[a])
        coded = mesh[a].psum(coded)
    if on_processes:
        return y, aux, coded
    first = (0,) * len(order)
    return _join_batch(y, order), aux[first], coded[first]


def moe_apply_eshard(params, x, cfg: ModelConfig, mesh=None):
    """``moe_impl="eshard"``: the reference's expert-sharded MoE.

    ``mesh`` (default: ``current_mesh()``) holds a ``"model"`` axis and
    data axes; without a ``"model"`` axis this is ``moe_apply``, as in
    the reference.  The batch splits over the data axes (in mesh order,
    the first major) and is replicated over ``"model"``; ``"model"``
    rank m owns experts ``[m·E/tp, (m+1)·E/tp)``.  Each data shard's
    slots take positions token-major, k-minor, per expert, and a slot
    past the batch-global ``moe_capacity(tokens of the shard)`` is
    dropped (not the streaming capacity: this is a training path, and
    its decode is not the forward's).  Each rank's experts run over its
    data shard's buffer, each rank combines its own experts' slots (a
    token's slots in slot order), and a psum over ``"model"`` adds the
    ranks' partial outputs in rank order, rounding each add, as XLA's
    psum does.  The aux loss is the Switch loss of each data shard,
    averaged by a pmean over ``"model"`` and then over each data axis.
    The shared expert runs over the whole ``x``.

    On loopback axes (``comm.loopback_mesh``) ``x`` is the global batch
    and every rank is stacked in this process: the router runs once over
    every rank's rows, and each expert runs one product over the buffers
    of every data shard (``_experts``), the rows its data ranks give it.
    On process-group axes (``comm.process_group_mesh``) ``x`` is this
    process's data shard: the process routes its rows, runs its own
    experts over its shard's buffer and combines their slots, and
    ``mesh["model"].psum`` adds the ranks' outputs (bf16: all-gathered,
    then added in rank order on every process).  Returns (y, aux).
    Raises for an ``n_experts`` that the ``"model"`` size does not
    divide, a global batch (loopback) that the data axes do not divide,
    and a mesh that mixes loopback and process-group axes.
    """
    mesh = current_mesh() if mesh is None else mesh
    if not mesh or "model" not in mesh:
        return moe_apply(params, x, cfg)
    on_processes = _on_processes(mesh, "moe_apply_eshard")
    tp = mesh["model"].size
    e, k = cfg.n_experts, cfg.experts_per_token
    if e % tp != 0:
        raise ValueError(f"n_experts={e} not divisible by axis 'model' "
                         f"size {tp}")
    data_axes = tuple(a for a in mesh if a != "model")
    dp = 1 if on_processes else math.prod(mesh[a].size for a in data_axes)
    b, s, d = x.shape
    if b % dp != 0:
        raise ValueError(f"batch {b} not divisible by the data axes "
                         f"{data_axes} ({dp} shards)")
    e_local, n_local = e // tp, b // dp * s
    cap = moe_capacity(n_local, cfg)

    if on_processes:
        y, aux = _eshard_process(params, x, cfg, mesh, data_axes, e_local,
                                 cap)
    else:
        y, aux = _eshard_loopback(params, x, cfg, mesh, data_axes, e_local,
                                  cap)
    if cfg.n_shared_experts > 0:
        y = y + mlp_apply(params["shared"], x.reshape(-1, d),
                          cfg).reshape(x.shape)
    return y, aux


def _eshard_process(params, x, cfg: ModelConfig, mesh, data_axes,
                    e_local: int, cap: int):
    """``moe_apply_eshard`` of this process's rows (a process-group
    mesh): its "model" rank's experts, one psum over "model"."""
    b, s, d = x.shape
    n, k, e = b * s, cfg.experts_per_token, cfg.n_experts
    model = mesh["model"]
    m = model.rank
    lo = m * e_local
    xz = _replicated_in(x, model).reshape(1, n, d)
    router = {"router": _replicated_in(params["router"], model)}
    topw, topi, probs = _route_probs(router, xz.reshape(n, d), cfg)
    topi = topi.reshape(1, n, k)
    aux = _aux(topi, probs.reshape(1, n, e), cfg)[0]
    buf, slot, _ = _dispatch(xz, topi, cfg, cap, thr=cap)
    out = _experts(buf[:, lo:lo + e_local],
                   _expert_weights(params)[lo:lo + e_local], cfg)
    # this rank's kept slots, as rows of its (1, E/tp, C, d) outputs;
    # every other slot reads the zero row
    mine = (topi.reshape(1, n * k) // e_local == m) & (slot < e * cap)
    local = torch.where(mine, slot - lo * cap, e_local * cap)
    y = _combine(out, local, topw.reshape(1, n, k), n)
    y = _psum(y, model).reshape(x.shape)
    aux = _psum(aux, model) / model.size     # the same rows' aux on each
    for a in data_axes:
        aux = _pmean(aux, mesh[a])
    return y, aux


def _eshard_loopback(params, x, cfg: ModelConfig, mesh, data_axes,
                     e_local: int, cap: int):
    """``moe_apply_eshard`` of the global batch on a loopback mesh:
    every rank at once."""
    b, s, d = x.shape
    e, k, tp = cfg.n_experts, cfg.experts_per_token, mesh["model"].size
    dp = math.prod(mesh[a].size for a in data_axes)
    n_local = b // dp * s
    xs, order = _split_batch(x, mesh, data_axes)   # data dims + (B/dp,S,d)
    xz = xs.reshape(dp, n_local, d)                # one row group a shard
    topw, topi, probs = _route_probs(params, xz.reshape(-1, d), cfg)
    topi = topi.reshape(dp, n_local, k)
    aux_shard = _aux(topi, probs.reshape(dp, n_local, e), cfg)     # (dp,)
    buf, slot, _ = _dispatch(xz, topi, cfg, cap, thr=cap)
    out_buf = _experts(buf, _expert_weights(params), cfg)

    # each rank combines its own experts' slots; the rest read the zero row
    owner = topi.reshape(dp, n_local * k) // e_local
    dump = dp * e * cap
    topw = topw.reshape(dp, n_local, k)
    parts = torch.stack([_combine(out_buf, torch.where(owner == m, slot,
                                                       dump), topw, n_local)
                         for m in range(tp)], dim=1)   # (dp, tp, n, d)

    # onto the mesh's rank dims: the data dims in mesh order, "model"
    # at its own dim
    mdim = mesh["model"].dim
    data_sizes = xs.shape[:len(order)]
    ranked = parts.reshape(*data_sizes, tp, n_local, d).movedim(
        len(order), mdim)
    aux = aux_shard.reshape(*data_sizes, 1).expand(
        *data_sizes, tp).movedim(-1, mdim)
    y = mesh["model"].psum(ranked).select(mdim, 0)
    aux = mesh["model"].psum(aux) / tp
    for a in data_axes:
        aux = mesh[a].psum(aux) / mesh[a].size
    y = _join_batch(y.reshape(*data_sizes, b // dp, s, d), order)
    return y, aux.reshape(-1)[0]
