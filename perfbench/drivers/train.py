"""Train driver: back-to-back steps of the program's train step with
AdamW and the gradient probe in ledger mode.

Set-up builds one step object (``make_train_step``, a
``CapturedTrainStep`` on the card) over one state from the seed's
weights, books from ``bootstrap_codebooks`` (no refresh), and drives it
through its first three steps, on three distinct seeded batches, through
the same call and the same one ``metrics_to_host`` copy a step that the
window uses (the first step is the capture's eager warm-up, the second
and third are replays, as every step of the window is).  After the
first step it reads each leaf's norm of m₁ / (1 − b1), the first clipped
gradient as the optimizer got it; after the second, each leaf's norm of
(m₂ − b1 · m₁) / (1 − b1), the second (a replay's); after the third,
each leaf's norm of the parameters' change.  It keeps on the host the
parameters that the second and the third step start from, and m₁.  The window: further steps back to back, a new
batch each, until ``seconds`` have passed; a traced run profiles the
second step of the window whole.

After the window and the memory peak the state is freed, and the
reference (``reference.train``: float32 loss and AdamW from the same
weights and batches) follows the first three steps:

- ``loss_gap``: the widest relative gap of a step's loss;
- ``grad1_gap``: the worst leaf's gap of the first gradient's norm;
- ``delta_gap``: the worst leaf's gap of the change's norm after three
  steps;
- ``grad2_gap``: the worst leaf's gap of the second gradient's norm
  against the reference's gradient at the parameters the program's
  second step started from (all three gaps over the larger of the
  leaf's and the median leaf's norm, leaves with a first gradient under
  a thousandth of the median leaf's left out);
- ``probe_gap``: the widest relative gap, over the three steps, of the
  probe's coded gradient bits against the reference's gradient at the
  parameters that step started from, as bf16, under the bootstrap
  books worked out again;
- ``raw_bits_off``: the probe's raw bits against 16 a parameter, the
  widest over the three steps (exact).

A replayed step is thus judged by itself (``grad2_gap``, ``probe_gap``)
as well as along the path from the served weights (``loss_gap``,
``delta_gap``), where the first Adam step's sign of near-nought
gradients, which bf16 and float32 round apart, lets the paths drift.

With ``faults["control"]`` the control (the reference in fp8) stands in
the program's place in all but ``raw_bits_off``, along its own path
and, at the program's parameters, step by step; ``faults`` also plant
``half_batch`` (half of each row's tokens left out of the loss, the mean
taken over the rest) and ``state_unchanged`` (a step that leaves the
weights as they were).
"""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Any, Dict

import torch

from perfbench.lib.cell import model_config
from perfbench.lib.compare import compared, passed
from perfbench.lib.traffic import train_batches
from perfbench.lib.weights import make_params
from perfbench.reference import huffman
from perfbench.reference.train import (_leaves, gradient_at, leaf_gaps,
                                       losses_gap, train_steps)
from perfbench.reference.common import Precision

FIRST = 3


def _norms(tree, scale: float = 1.0) -> Dict:
    paths, vals = [], []
    for p, t in _leaves(tree):
        paths.append(p)
        vals.append(torch.linalg.vector_norm(t.to(torch.float32)) * scale)
    return dict(zip(paths, torch.stack(vals).cpu().tolist()))


def _grad2_norms(m_tree, m1: Dict, b1: float) -> Dict:
    """Each leaf's norm of (m₂ − b1 · m₁) / (1 − b1): the second step's
    clipped gradient, from the moments after the second and first."""
    paths, vals = [], []
    for p, m2 in _leaves(m_tree):
        paths.append(p)
        vals.append(torch.linalg.vector_norm(
            m2 - b1 * m1[p].to(m2.device)) / (1.0 - b1))
    return dict(zip(paths, torch.stack(vals).cpu().tolist()))


def _to_host(tree) -> Dict:
    return {p: t.detach().to("cpu", copy=True) for p, t in _leaves(tree)}


def _diff_norms(a_tree, b_tree) -> Dict:
    paths, vals = [], []
    for (p, a), (_, b) in zip(_leaves(a_tree), _leaves(b_tree)):
        paths.append(p)
        vals.append(torch.linalg.vector_norm(a.to(torch.float32)
                                             - b.to(torch.float32)))
    return dict(zip(paths, torch.stack(vals).cpu().tolist()))


def _boot_lengths(params) -> Dict:
    """The bootstrap books worked out again from the same weights: the
    first 65 536 elements of each of the first 8 leaves, as bf16."""
    sample = torch.cat([t.detach().reshape(-1)[:65536].to(torch.float32)
                        for _, t in list(_leaves(params))[:8]])
    return huffman.books_of(sample)


def run(ctx, tracer) -> Dict[str, Any]:
    from repro_torch.capture import release
    from repro_torch.device import metrics_to_host
    from repro_torch.launch.train import bootstrap_codebooks
    from repro_torch.lifecycle import BookLifecycleManager, DriftThresholds
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (CapturedTrainStep, make_train_step,
                                        train_state_init)

    dev, tr, opt = ctx.device, ctx.traffic, ctx.workload["optimizer"]
    cuda = dev.type == "cuda"
    cfg = model_config(ctx.conf, ctx.overrides.get("model"))
    params = make_params(cfg, ctx.seed, dev)
    batches = train_batches(tr, cfg.vocab_size, ctx.seed, dev)
    if ctx.faults.get("half_batch"):
        for b in batches:
            mask = torch.ones(b["labels"].shape, device=dev)
            mask[:, mask.shape[1] // 2:] = 0.0
            b["loss_mask"] = mask
    state = train_state_init(params)
    lifecycle = BookLifecycleManager(
        thresholds=DriftThresholds(min_symbols=1024))
    bootstrap_codebooks(state, lifecycle)
    spec = lifecycle.spec("grad", "bf16", mode="ledger")
    step = make_train_step(cfg, AdamWConfig(**opt), None, grad_accum=1,
                           comp_spec=spec)
    if cuda:
        step = CapturedTrainStep(step)

    first, starts = [], []
    for i in range(FIRST):
        state, met = step(state, batches[i])
        first.append({k: v for k, v in metrics_to_host(met).items()
                      if isinstance(v, float)})
        if i == 0:
            grads = [_norms(state.opt.m, 1.0 / (1.0 - opt["b1"]))]
            m1 = _to_host(state.opt.m)
        elif i == 1:
            grads.append(_grad2_norms(state.opt.m, m1, opt["b1"]))
            del m1
        if i < FIRST - 1:
            starts.append(_to_host(state.params))
    if ctx.faults.get("state_unchanged"):
        delta = {p: 0.0 for p, _ in _leaves(params)}
    else:
        delta = _diff_norms(state.params, params)
    if cuda:
        torch.cuda.synchronize()

    t_win = time.perf_counter()
    setup_s = t_win - ctx.t_start
    step_s, n = [], 0
    while True:
        batch = batches[(FIRST + n) % len(batches)]
        profiled = n == 1 and ctx.trace
        t0 = time.perf_counter()
        with tracer.slice() if profiled else contextlib.nullcontext():
            with tracer.span("train.step"):
                state, met = step(state, batch)
            with tracer.span("train.metrics_to_host"):
                metrics_to_host(met)
        t1 = time.perf_counter()
        step_s.append((t1 - t0, profiled))
        n += 1
        if t1 - t_win >= ctx.seconds and n >= (3 if ctx.trace else 1):
            break
    window_s = t1 - t_win
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    release(step)
    del state, step, met
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    checks = check(ctx, params, batches[:FIRST], first, grads, delta,
                   starts)
    ctx.info["reference_s"] = time.perf_counter() - t_ref
    record = {"model": ctx.model, "batch": tr["batch"],
              "seq_len": tr["seq_len"], "steps": n,
              "step_s": [t for t, traced in step_s if not traced],
              "setup_s": setup_s, "window_s": window_s,
              "trace": tracer.summary}
    failed = 0 if passed(checks) else n
    return {"record": record, "checks": checks, "attempted": n,
            "failed": failed, "memory_peak_bytes": peak}


def check(ctx, params, batches, first, grads, delta, starts):
    """``starts``: the parameters the second and the third step started
    from, on the host."""
    from perfbench.roofline.analytic import param_count
    m, opt, lim = ctx.model, ctx.workload["optimizer"], ctx.check["limits"]
    model = importlib.import_module(
        f"perfbench.reference.{ctx.conf['reference']}")
    boot = _boot_lengths(params)

    def coded(hist):
        return sum(int((hist[p] * boot[p]).sum()) for p in huffman.PLANES)

    def numbers_of(path, steps, ref, ref_steps, probe_bits):
        """The numbers compared: ``path`` (losses, first gradient,
        change) against the reference's path ``ref``, and ``steps``
        (second gradient) and each step's coded bits against the
        reference's readings at the same parameters, ``ref_steps``."""
        g0 = ref["grad1"]
        return {
            "loss_gap": losses_gap(path["loss"], ref["loss"]),
            "grad1_gap": leaf_gaps(path["grad1"], g0, g0)["worst"],
            "delta_gap": leaf_gaps(path["delta"], ref["delta"], g0)["worst"],
            "grad2_gap": leaf_gaps(steps[0], ref_steps[0]["grad"],
                                   g0)["worst"],
            "probe_gap": max(abs(b - w) / w for b, w in zip(
                probe_bits, [coded(r["hist"]) for r in
                             [{"hist": ref["hist1"]}] + ref_steps])),
        }

    def at_starts(prec=Precision()):
        return [gradient_at(model, params, v, b, m, opt["grad_clip"], prec)
                for v, b in zip(starts, batches[1:])]

    ref = train_steps(model, params, batches, m, opt)
    ref_steps = at_starts()
    program = {"loss": [f["loss"] for f in first], "grad1": grads[0],
               "delta": delta}
    numbers = numbers_of(program, grads[1:], ref, ref_steps,
                         [f["grad_coded_bits"] for f in first])
    numbers["raw_bits_off"] = max(abs(f["grad_raw_bits"]
                                      - 16.0 * param_count(m))
                                  for f in first)
    g0 = ref["grad1"]
    ctx.info = {"loss": program["loss"], "loss_ref": ref["loss"],
                "leaves": leaf_gaps(grads[0], g0, g0)["leaves"],
                "grad1_leaf": leaf_gaps(grads[0], g0, g0)["leaf"],
                "grad2_leaf": leaf_gaps(grads[1], ref_steps[0]["grad"],
                                        g0)["leaf"],
                "delta_leaf": leaf_gaps(delta, ref["delta"], g0)["leaf"]}
    control = None
    if ctx.faults.get("control"):
        prec = Precision(ctx.faults["control"])
        low = train_steps(model, params, batches, m, opt, prec=prec)
        low_steps = at_starts(prec)
        control = numbers_of(low, [low_steps[0]["grad"]], ref, ref_steps,
                             [coded(h) for h in [low["hist1"]]
                              + [r["hist"] for r in low_steps]])
    return compared(numbers, lim, control)
