"""Plain training steps: the model's float32 loss by autograd and
AdamW in float32, from the served bf16 weights upcast once.

AdamW as the configuration states it (``optimizer`` of the workload
file): the gradient clipped by its global norm to ``grad_clip``
(scale min(1, clip / (‖g‖ + 1e-9))), moments m ← b1·m + (1 − b1)·g and
v ← b2·v + (1 − b2)·g² in float32, the update (m / (1 − b1^t)) /
(√(v / (1 − b2^t)) + eps) + weight_decay · p, times ``lr``, every leaf
decayed.  The parameters are held in the dtype the configuration gives
them (bf16 weights, float32 norms and SSM scalars): each step's new
value is rounded to it, as a state of that dtype stores it; an update
under half a bf16 ulp leaves a weight where it was.

``train_steps`` returns what the benchmark compares along the
reference's own path from the served weights: each step's loss, each
leaf's norm of the first clipped gradient (what the optimizer got),
each leaf's norm of the parameters' change after the steps, and the
first gradient's bf16 planes' histograms.  ``gradient_at`` gives the
same readings of one step's gradient at given parameter values, such
as the program's own after its earlier steps: a later step is then
judged by itself, free of the drift of the paths before it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import huffman
from .common import Precision, exact_float32


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, made, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, made, path + (i,))
                          for i, v in enumerate(tree))
    return made[path]


def _gradient(model, template, cur: Dict, batch, m: Dict, grad_clip: float,
              prec: Precision):
    """The loss at the float32 leaves ``cur`` (keyed by path, laid out
    as ``template``), the gradient, its clip factor, each leaf's norm of
    the clipped gradient and the bf16 planes' histograms."""
    paths = list(cur)
    leaves = [cur[p].requires_grad_(True) for p in paths]
    tree = _rebuild(template, dict(zip(paths, leaves)))
    with torch.enable_grad():
        lv = model.loss(tree, batch["tokens"], batch["labels"], m, prec=prec)
        grads = torch.autograd.grad(lv, leaves)
    with torch.no_grad():
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        clip = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        norms = {p: float(torch.linalg.vector_norm(g * clip))
                 for p, g in zip(paths, grads)}
        flat = torch.cat([g.reshape(-1) for g in grads])
        hist = {k: huffman.histogram(s)
                for k, s in huffman.bf16_planes(flat).items()}
    for t in leaves:
        t.requires_grad_(False)
    return float(lv.detach()), grads, clip, norms, hist


def train_steps(model, params, batches: Sequence[Dict[str, torch.Tensor]],
                m: Dict, opt: Dict, prec: Precision = Precision()
                ) -> Dict[str, object]:
    paths = [p for p, _ in _leaves(params)]
    dtypes = {p: t.dtype for p, t in _leaves(params)}
    p0 = {p: t.detach().to(torch.float32) for p, t in _leaves(params)}
    cur = {p: t.clone() for p, t in p0.items()}
    mom = {p: torch.zeros_like(t) for p, t in p0.items()}
    vel = {p: torch.zeros_like(t) for p, t in p0.items()}
    out: Dict[str, object] = {"loss": []}
    with exact_float32():
        for step, batch in enumerate(batches, start=1):
            loss, grads, clip, norms, hist = _gradient(
                model, params, cur, batch, m, opt["grad_clip"], prec)
            out["loss"].append(loss)
            if step == 1:
                out["grad1"], out["hist1"] = norms, hist
            with torch.no_grad():
                b1c = 1 - opt["b1"] ** step
                b2c = 1 - opt["b2"] ** step
                for p, g in zip(paths, grads):
                    g = g * clip
                    mom[p].mul_(opt["b1"]).add_(g * (1 - opt["b1"]))
                    vel[p].mul_(opt["b2"]).add_(g * g * (1 - opt["b2"]))
                    upd = (mom[p] / b1c) / (torch.sqrt(vel[p] / b2c)
                                            + opt["eps"])
                    upd = upd + opt["weight_decay"] * cur[p]
                    cur[p] = (cur[p].detach() - opt["lr"] * upd).to(
                        dtypes[p]).to(torch.float32)
            del grads
        out["delta"] = {p: float(torch.linalg.vector_norm(cur[p] - p0[p]))
                        for p in paths}
    return out


def gradient_at(model, template, values: Dict, batch, m: Dict,
                grad_clip: float, prec: Precision = Precision()
                ) -> Dict[str, Dict]:
    """Each leaf's norm of the clipped gradient (``grad``) and the bf16
    planes' histograms (``hist``) at the parameter values ``values``
    (keyed by path, on any device), laid out as ``template``."""
    dev = batch["tokens"].device
    cur = {p: values[p].to(dev, torch.float32) for p, _ in
           _leaves(template)}
    with exact_float32():
        _, grads, _, norms, hist = _gradient(model, template, cur, batch, m,
                                             grad_clip, prec)
    del grads, cur
    return {"grad": norms, "hist": hist}


def _median(v) -> float:
    v = sorted(v)
    return v[len(v) // 2]


def leaf_gaps(got: Dict, want: Dict, grad_ref: Dict,
              floor_of_median: float = 1e-3) -> Dict[str, float]:
    """The worst leaf's gap between two per-leaf norms, each over the
    larger of the reference's norm of that leaf and the median leaf's.
    Leaves whose reference first gradient is under ``floor_of_median``
    of the median leaf's are left out: their gradient is nought to
    rounding (as a bias under a softmax), and Adam moves them by
    round-off alone."""
    g_med = _median(grad_ref.values())
    keep = [p for p in want if grad_ref[p] >= floor_of_median * g_med]
    median = _median([want[p] for p in keep])
    gaps = {p: abs(got[p] - want[p]) / max(want[p], median) for p in keep}
    worst = max(gaps, key=gaps.get)
    return {"worst": gaps[worst], "leaf": "/".join(map(str, worst)),
            "leaves": len(keep), "median": median}


def losses_gap(got: List[float], want: List[float]) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))
