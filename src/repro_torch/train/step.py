"""Training step (port of ``repro.train.step``): loss, gradient
accumulation, AdamW, and the fixed-codebook compression probe on the
gradient all-reduce payload.

The forward and backward are plain PyTorch with autograd (the
reference's are plain XLA); the model's large products stay
``torch.matmul``.  With ``grad_accum > 1`` the global batch splits into
microbatches whose gradients add up in float32, as the reference's scan
adds them.

When a ``CompressionSpec`` is supplied, the step computes the exact
coded size of the gradient payload under the fixed codebook — each leaf
cast to bf16 (what rides the data-parallel wire), split into byte
planes, counted by kernel B5 on the card (``comm.compression
.payload_stats``) and dotted with the books' lengths in int64 — and
returns it with the per-plane histograms in the metrics; the host
lifecycle observes those (``lifecycle.BookLifecycleManager
.observe_train_metrics``), and the ledger scales the all-reduce bytes by
the analytic ring factors.  Bit metrics are float64 tensors (exact
integers); loss, grad norm and learning rate are float32, as in the
reference.  Nothing in a step waits for the device.

The compiled step: on CUDA the train loops run ``make_train_step``'s
step as a ``CapturedTrainStep``, captured once as a CUDA graph for each
batch signature (and, through ``lifecycle.compiled``, each book epoch)
and replayed for every later step: the reference's ``jax.jit`` of the
step.  The plain step is its eager version, and the step on the CPU.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..capture import Capture, CapturedGraphs, check_leaves
from ..comm.compression import CompressionSpec, payload_stats, shannon_bits
from ..models.common import ModelConfig, tree_leaves, tree_map, tree_unflatten
from ..models.transformer import forward_train
from ..optim.adamw import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["TrainState", "train_state_init", "make_train_step",
           "CapturedTrainStep", "cross_entropy_loss", "grad_payload_stats",
           "loss_and_grads", "STEP_TOL", "step_deviation"]

# How far one bf16 train step of the port may be from another
# implementation's on the same params and batch (the reference on the
# CPU, or the port's plain path against the card): the two add in other
# orders and round each bf16 product and gradient on their own.
#   loss, grad_norm  relative
#   grads            per leaf, |Δ| ≤ tol × max |g| of the leaf (also
#                    the optimizer's first moment)
#   params           after a step, each entry within ``param_steps`` ×
#                    the step's lr (Adam's first step is ±lr, so a
#                    near-zero gradient whose sign differs moves 2·lr)
#                    plus one bf16 ulp (``param_ulp`` × |p|), and at
#                    most ``param_flips`` of a leaf beyond the ulp
# Each limit is about three times the largest reading of
# ``step_deviation`` in the reduced model's parity runs (PERF.md §2),
# except ``param_steps``: a flipped first Adam step is 2·lr by
# construction, and sound runs read 1.98.
STEP_TOL = {"loss": 2e-4, "grad_norm": 3e-4, "grads": 2e-2,
            "param_ulp": 2.0 ** -7, "param_steps": 2.0, "param_flips": 0.03}


def _f64(x) -> np.ndarray:
    """A leaf (a tensor on any device, or an array; bf16 included) as
    float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).cpu().numpy()
    return np.asarray(x).astype(np.float64)


def _leaf_rel(g: np.ndarray, w: np.ndarray) -> float:
    """max |g − w| / max |w|; a zero leaf (a prefix-only model's token
    table gradient) reads 0 when both are zero, inf otherwise."""
    d, top = float(np.abs(g - w).max()), float(np.abs(w).max())
    return d / top if top else (0.0 if d == 0.0 else float("inf"))


def step_deviation(got: Dict[str, Any], want: Dict[str, Any],
                   lr: Optional[float] = None) -> Dict[str, float]:
    """How far one step's results are from another's, in ``STEP_TOL``'s
    units: a step is within tolerance when every reading is at most the
    limit of its name.

    ``got`` and ``want`` hold any of ``loss``, ``ce``, ``grad_norm``
    (numbers), ``grads``, ``m`` (trees: the gradients, the first
    moments) and ``params`` (the trees after the step; needs ``lr``).
    Readings, each present when its inputs are:
      ``loss``         the larger relative difference of loss and ce;
      ``grad_norm``    relative;
      ``grads``        the largest max |Δ| / max |want| of a leaf, over
                       the gradients and the first moments;
      ``param_steps``  the largest (|Δ| − one ulp) / lr of an entry;
      ``param_flips``  the largest share of a leaf beyond one ulp.
    """
    out: Dict[str, float] = {}

    def rel(k):
        a, b = float(got[k]), float(want[k])
        return abs(a - b) / abs(b)

    for name, keys in (("loss", ("loss", "ce")), ("grad_norm", ("grad_norm",)),
                       ("grads", ("grads", "m"))):
        keys = [k for k in keys if k in got and k in want]
        if not keys:
            continue
        if name != "grads":
            out[name] = max(rel(k) for k in keys)
            continue
        out[name] = max(
            _leaf_rel(_f64(g), w) for k in keys for g, w in zip(
                tree_leaves(got[k]), map(_f64, tree_leaves(want[k]))))
    if "params" in got and "params" in want:
        steps = flips = 0.0
        for g, w in zip(tree_leaves(got["params"]),
                        tree_leaves(want["params"])):
            g, w = _f64(g), _f64(w)
            d = np.abs(g - w)
            ulp = STEP_TOL["param_ulp"] * np.abs(w)
            steps = max(steps, float(((d - ulp) / lr).max()))
            flips = max(flips, float((d > ulp + 1e-12).mean()))
        out["param_steps"], out["param_flips"] = max(steps, 0.0), flips
    return out


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def train_state_init(params) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params))


def cross_entropy_loss(logits, labels, mask=None):
    """Mean token cross-entropy in float32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].to(torch.int64))[..., 0]
    if mask is None:
        return -ll.mean()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def grad_payload_stats(grads, spec: Optional[CompressionSpec]
                       ) -> Dict[str, torch.Tensor]:
    """Exact coded size of the (bf16) gradient payload under the fixed
    codebook — leaf by leaf, no giant concat.  Also returns the
    per-plane symbol histograms (``hist_<plane>``, int64) so the host
    registry can keep observing real gradient PMFs and rebuild codebooks
    off the critical path (paper §4), plus the payload's exact Shannon
    bits: the ``coded − shannon`` gap is the drift probe the lifecycle
    monitor thresholds.  Values are 0-d float64 tensors on the
    gradients' device."""
    leaves = tree_leaves(grads)
    z = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    if spec is None or not spec.enabled:
        return {"raw_bits": z, "coded_bits": z, "shannon_bits": z}
    raw = 0
    coded = z
    hists = {p: None for p in spec.scheme.planes}
    for leaf in leaves:
        if leaf.dtype != torch.bfloat16:
            leaf = leaf.to(torch.bfloat16)     # what rides the DP wire
        raw += leaf.numel() * 16
        s = payload_stats(leaf, spec, with_hists=True)
        coded = coded + s["coded_bits"]
        for p in hists:
            h = s[f"hist_{p}"]
            hists[p] = h if hists[p] is None else hists[p] + h
    shannon = z
    for h in hists.values():
        shannon = shannon + shannon_bits(h)
    out = {"raw_bits": z + float(raw), "coded_bits": coded,
           "shannon_bits": shannon}
    for p, h in hists.items():
        out[f"hist_{p}"] = h
    return out


def loss_and_grads(params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, grad_accum: int = 1):
    """(loss, (ce, aux, moe_wire_coded_bits), grads) of one global batch,
    by autograd: the gradients keep the params' dtypes with
    ``grad_accum == 1`` and are float32 averages of the microbatches'
    otherwise (the reference's ``value_and_grad`` and scan)."""
    def grad_fn(micro):
        req = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if cfg.prefix_only:
            # a prefix-only batch has no tokens: the forward never reads
            # the token table, whose gradient is zero, as in the
            # reference; every other leaf must be read (autograd raises)
            req["embed"]["table"].requires_grad_(False)
        leaves = tree_leaves(req)
        with torch.enable_grad():
            logits, aux, fstats = forward_train(req, micro, cfg,
                                                with_stats=True)
            ce = cross_entropy_loss(logits, micro["labels"],
                                    micro.get("loss_mask"))
            loss = ce + aux
            got = iter(torch.autograd.grad(
                loss, [p for p in leaves if p.requires_grad]))
        grads = [next(got) if p.requires_grad else torch.zeros_like(p)
                 for p in leaves]
        return (loss.detach(), (ce.detach(), aux,
                                fstats["moe_wire_coded_bits"]),
                tree_unflatten(params, grads))

    if grad_accum == 1:
        return grad_fn(batch)
    micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                          + tuple(v.shape[1:])) for k, v in batch.items()}
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    acc = None
    for i in range(grad_accum):
        loss, extra, g = grad_fn({k: v[i] for k, v in micro.items()})
        for a, b in zip(g_acc, tree_leaves(g)):
            a.add_(b)
        del g
        vals = (loss,) + extra
        acc = vals if acc is None else tuple(x + y for x, y in zip(acc, vals))
    inv = 1.0 / grad_accum
    grads = tree_unflatten(params, [g * inv for g in g_acc])
    loss, ce, aux, moe = acc
    return loss * inv, (ce * inv, aux * inv, moe), grads


def make_train_step(model_cfg: ModelConfig, opt_cfg: AdamWConfig,
                    schedule_fn: Optional[Callable] = None,
                    grad_accum: int = 1,
                    comp_spec: Optional[CompressionSpec] = None,
                    dp_degree: int = 1,
                    grad_sync: str = "all_reduce",
                    dp_axis_sizes: Optional[Tuple[int, int]] = None,
                    ep_degree: int = 1):
    """The train step: (state, batch) → (state, metrics).

    Batch leaves are (B, ...) tensors on the params' device; with
    ``grad_accum=A`` they split into A microbatches of B/A.

    **The step consumes the state it is given**: the optimizer moments
    are updated in place (``optim.adamw_update``), so the returned state
    shares them with the input, whose ``step`` is then out of date.
    Use only the returned state, and do not retry a step that raised
    after the backward pass; clone the moments first to keep a state.
    The params come back as new tensors.

    With a CompressionSpec the metrics carry the gradient payload probe
    (``grad_raw_bits``, ``grad_coded_bits``, ``grad_shannon_bits``,
    ``grad_hist_<plane>``), the books' ``book_epoch``, and the sync's
    *wire* traffic on a ``dp_degree``-way ring under ``grad_sync``:

      ``"all_reduce"``      one 2(n−1)/n all-reduce (``grad_wire_*``);
      ``"reduce_scatter"``  the ZeRO-style legs, reduce-scatter of the
                            gradients and all-gather of the params, each
                            (n−1)/n (``grad_wire_rs_*``/``grad_wire_ag_*``,
                            ``grad_wire_*`` their sum);

    and, when ``comp_spec.axes`` names a two-axis ring with
    ``dp_axis_sizes = (n_inner, n_outer)``, the hierarchical volume and
    its per-axis split (``grad_wire_{inner,outer}_*``).  With a spec,
    ``moe_dispatch_raw_bits`` is the raw bits of the batch's MoE dispatch
    and combine (every routed slot's hidden state out and back, a MoE
    layer) and ``moe_wire_raw_bits`` that times the ``ep_degree``-way
    all-to-all factor (0 without expert parallelism or an MoE layer);
    ``moe_wire_coded_bits`` is the coded wire's measured ledger from
    ``forward_train`` (``moe_impl="a2a"`` on a mesh).
    """
    if grad_sync not in ("all_reduce", "reduce_scatter"):
        raise ValueError(f"unknown grad_sync {grad_sync!r}; one of "
                         f"('all_reduce', 'reduce_scatter')")
    if dp_axis_sizes is not None:
        n1, n2 = dp_axis_sizes
        if n1 * n2 != dp_degree:
            raise ValueError(f"dp_axis_sizes {dp_axis_sizes} must multiply "
                             f"to dp_degree={dp_degree}")
        if grad_sync == "reduce_scatter":
            raise ValueError(
                "grad_sync='reduce_scatter' accounting is flat-ring only; "
                "drop dp_axis_sizes (hierarchical ZeRO legs are not "
                "modeled yet)")
    from ..comm.transport import moe_ep_raw_bits, wire_factor
    enabled = comp_spec is not None and comp_spec.enabled
    rs_factor = ag_factor = 0.0
    if enabled and dp_degree > 1:
        if grad_sync == "reduce_scatter":
            rs_factor = wire_factor("reduce_scatter", dp_degree)
            ag_factor = (dp_degree - 1) / dp_degree   # (n−1) × shard/n
        elif comp_spec.axes is not None and dp_axis_sizes is not None:
            from ..comm.hierarchy import hierarchical_wire_factor
            rs_factor = hierarchical_wire_factor(*dp_axis_sizes)
        else:
            rs_factor = wire_factor("all_reduce", dp_degree)
    split = (enabled and dp_degree > 1 and comp_spec.axes is not None
             and dp_axis_sizes is not None)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, (ce, aux, moe_coded), grads = loss_and_grads(
            state.params, batch, model_cfg, grad_accum)
        comp = grad_payload_stats(grads, comp_spec)
        lr_scale = (schedule_fn(state.opt.step) if schedule_fn is not None
                    else 1.0)
        params, opt, om = adamw_update(grads, state.opt, state.params,
                                       opt_cfg, lr_scale)
        del grads
        raw, coded = comp["raw_bits"], comp["coded_bits"]
        z = torch.zeros_like(raw)
        metrics = {"loss": loss, "ce": ce, "aux": aux,
                   "grad_raw_bits": raw, "grad_coded_bits": coded,
                   "grad_shannon_bits": comp["shannon_bits"],
                   "book_epoch": z + float(comp_spec.book_epoch
                                           if comp_spec is not None else 0),
                   "moe_wire_coded_bits": moe_coded,
                   "grad_wire_raw_bits": (rs_factor + ag_factor) * raw,
                   "grad_wire_coded_bits": (rs_factor + ag_factor) * coded,
                   **om}
        if grad_sync == "reduce_scatter":
            metrics["grad_wire_rs_raw_bits"] = rs_factor * raw
            metrics["grad_wire_rs_coded_bits"] = rs_factor * coded
            metrics["grad_wire_ag_raw_bits"] = ag_factor * raw
            metrics["grad_wire_ag_coded_bits"] = ag_factor * coded
        if split:
            # the slow (outer) axis carries 2(n₂−1)/(n₁n₂) of the payload
            n1h, n2h = dp_axis_sizes
            inner_f = 2.0 * (n1h - 1) / n1h
            outer_f = 2.0 * (n2h - 1) / (n1h * n2h)
            metrics["grad_wire_inner_raw_bits"] = inner_f * raw
            metrics["grad_wire_inner_coded_bits"] = inner_f * coded
            metrics["grad_wire_outer_raw_bits"] = outer_f * raw
            metrics["grad_wire_outer_coded_bits"] = outer_f * coded
        if enabled:
            # the batch's token positions: every batch has labels (a
            # prefix-only batch has no tokens)
            dispatch, wire = moe_ep_raw_bits(
                model_cfg, batch["labels"].numel(),
                comp_spec.scheme.total_symbol_bits(), ep_degree)
            metrics["moe_dispatch_raw_bits"] = z + dispatch
            metrics["moe_wire_raw_bits"] = z + wire
            for k, v in comp.items():
                if k.startswith("hist_"):
                    metrics[f"grad_{k}"] = v
        return TrainState(params=params, opt=opt), metrics

    return step


class _TrainGraph:
    """One capture of a train step: its static batch buffers, the state
    whose tensors it reads and writes in place, its metrics and its
    ``capture.Capture``."""

    def __init__(self, step, state: TrainState, batch, capture: Capture):
        self.step = step
        self.state = state
        self.leaves = tree_leaves(state)
        self.batch = batch
        self.capture = capture
        self.metrics = None

    def body(self):
        """The recorded function: one step on the buffers, its new params
        and step count written back into them (the moments move in
        place in the step itself), returning the metrics."""
        new, metrics = self.step(self.state, self.batch)
        for dst, src in zip(self.leaves, tree_leaves(new)):
            if src is not dst:
                dst.copy_(src)
        return metrics

    def load(self, state: TrainState, batch) -> None:
        """The call's batch into the buffers, and its state unless it is
        the graph's own (the last call's output); on the device."""
        for k, dst in self.batch.items():
            if batch[k] is not dst:
                dst.copy_(batch[k])
        leaves = tree_leaves(state)
        check_leaves(leaves, self.leaves, "state")
        for dst, src in zip(self.leaves, leaves):
            if src is not dst:
                dst.copy_(src)


class CapturedTrainStep(CapturedGraphs):
    """A train step captured as a CUDA graph and replayed: the port's
    counterpart of the reference's ``jax.jit(make_train_step(...))``.

    Called as the step it wraps, ``(state, batch) → (state, metrics)``.
    The state is too large to copy (``gemma2-2b``'s moments alone are
    20 GB), so the first call for a batch signature (the batch's keys,
    shapes and dtypes and the state's leaf shapes and dtypes) runs one
    real eager step as the warm-up, on the capture's stream under its
    private accumulators, and returns its result; then it records the
    step on that result's tensors, which become the graph's buffers.
    Recording launches nothing, so no step is lost.  Every later call
    copies its batch into the graph's static buffers, and its state
    unless it is the graph's own, then replays.  Nothing falls back to
    the eager step: a capture or replay that fails raises.

    What the caller may hold on to: the first call consumes the state it
    is given as the eager step does (its moments move in place; its
    params are never written, so params a caller passed to
    ``train_state_init`` stay as they were).  The state every call
    returns is the graph's own: a replay writes its new params and step
    count into the same tensors and moves the moments in place, so the
    next call overwrites them; clone what must outlive it.  The metrics
    of a replay are the graph's buffers too: copy them
    (``device.metrics_to_host``) before the next call.

    ``release()`` drops every graph when the step's book epoch is
    superseded; the state last returned stays valid (its tensors lie
    outside the graphs' pools).  Launch counts and accumulators: see
    ``capture``.
    """

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        key = (tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items())),
               tuple((tuple(t.shape), t.dtype) for t in tree_leaves(state)))
        g = self._graphs.get(key)
        if g is None:
            state, metrics, self._graphs[key] = self._capture(state, batch)
            return state, metrics
        g.load(state, batch)
        g.capture.replay()
        return g.state, g.metrics

    def _capture(self, state: TrainState, batch):
        capture = Capture(tree_leaves(state)[0].device)
        buffers = {k: v.clone() for k, v in batch.items()}
        state, metrics = capture.warm_up(self.step, state, buffers)
        g = _TrainGraph(self.step, state, buffers, capture)
        g.metrics = capture.capture(g.body)
        return state, metrics, g
