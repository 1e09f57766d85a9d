"""Serve driver: a closed loop of batched ``Engine.generate`` calls
through the bitexact activation wire.

Set-up: weights from the seed; the mix's calls; the wire's books from
a warm-up prefill's last-position logits (a fixed book from an earlier
batch); the engine; one ``generate`` of the warm-up call (captures the
prefill and the decode step at the mix's one shape, builds the
kernels).  The
window: calls back to back until ``seconds`` have passed, each call's
host wall time on the harness's clock and its steps' ``step_seconds``
from the engine.  A traced run profiles the second call whole, with
spans around ``generate``, the prefill and each decode step.

After the window and the memory peak: the engine is freed, and the
reference is held to what the window produced:

- ``served_gap_max``: the widest gap of a served token below the
  float32 reference's best, over a seeded sample of the requests of one
  call drawn from the seed;
- ``served_logit_err_max``, ``_p999``, ``_p99``: the widest relative
  logit error of a decode step of those requests against the
  reference's, and its 99.9th and 99th percentiles (the cell's file
  names which are judged);
- ``wire_bits_off``: over every decode step of one call drawn from the
  seed, the program's coded bits and decoded bits against the
  reference's histogram · lengths of that step's logits, books worked
  out again from the warm-up logits' histograms (exact);
- ``decode_mismatch``: decoded symbols unequal to the coded ones, every
  step of the window (the engine's own count; exact);
- ``steps_over_wall_ms``: the most a call's steps sum to beyond the
  call's wall time.

With ``faults["control"]`` the control (the reference in fp8) stands in
the program's place in the first two; ``faults`` also plant the timed
path's faults: ``alter_token`` (a served token altered where it is
sampled) and ``stale_state`` (every decode step starts from the
prefill's caches: the state is not carried across steps).
"""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.lib.cell import model_config
from perfbench.lib.compare import compared
from perfbench.lib.traffic import ServeTraffic, stream_seed
from perfbench.lib.weights import make_params
from perfbench.reference import huffman
from perfbench.reference.served import (gap_numbers, pick_requests,
                                        served_gaps)


class _Recorder:
    """Wraps the engine's decode step and prefill: spans around each,
    and a copy of every decode step's logits into one of two buffers;
    after each call a reservoir draw (from the seed) keeps that call's
    buffer and metrics or lets the next call overwrite it."""

    def __init__(self, eng, tracer, steps: int, batch: int, vocab: int,
                 seed: int, device, stale: bool = False):
        self.eng, self.tracer = eng, tracer
        self.step, self.prefill = eng._step, eng._prefill
        eng._step, eng._prefill = self._step, self._prefill
        self.bufs = [torch.empty((max(steps, 1), batch, vocab),
                                 dtype=torch.bfloat16, device=device)
                     for _ in range(2)]
        self.cur, self.k = 0, 0
        self.rng = np.random.default_rng(stream_seed(seed, 3))
        self.kept: Dict[str, Any] = {}
        self.stale, self.first = stale, None

    def _step(self, *args):
        if self.stale:                  # the fault: state not carried
            from repro_torch.models.common import tree_map
            if self.k == 0:
                self.first = tree_map(torch.clone, args[2])
            args = (args[0], args[1], tree_map(torch.clone, self.first),
                    args[3])
        with self.tracer.span("serve.decode_step"):
            logits, caches, m = self.step(*args)
        self.bufs[self.cur][self.k].copy_(logits[:, 0])
        self.k += 1
        return logits, caches, m

    def _prefill(self, *args):
        with self.tracer.span("serve.prefill"):
            return self.prefill(*args)

    def start(self) -> None:
        self.k = 0

    def end_call(self, i: int) -> None:
        if self.rng.random() < 1.0 / (i + 1):
            self.kept = {"call": i, "logits": self.bufs[self.cur],
                         "metrics": list(self.eng.step_metrics)}
            self.cur = 1 - self.cur


def run(ctx, tracer) -> Dict[str, Any]:
    from repro_torch.capture import release
    from repro_torch.comm.compression import CompressionSpec, histogram256
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import SCHEMES
    from repro_torch.models.transformer import prefill
    from repro_torch.serve import Engine, ServeConfig

    dev, m, tr = ctx.device, ctx.model, ctx.traffic
    wire = ctx.workload["wire"]
    cfg = model_config(ctx.conf, ctx.overrides.get("model"))
    params = make_params(cfg, ctx.seed, dev)
    traffic = ServeTraffic(tr, cfg.vocab_size, cfg.d_model, ctx.seed, dev,
                           dtype=cfg.dtype)
    batch, new, npre = traffic.batch, traffic.new_tokens, traffic.prefix_len
    cache_len = traffic.prompt_len + npre + new

    # the wire's books: a warm-up prefill's last-position logits
    warm_toks, warm_prefix = traffic.warm
    wb = {"tokens": warm_toks}
    if warm_prefix is not None:
        wb["prefix_embeds"] = warm_prefix
    with torch.no_grad():
        wl, _ = prefill(params, wb, cfg, cache_len)
    warm_logits = wl[:, -1].to(torch.bfloat16).clone()
    del wl
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(warm_logits).items()}
    spec = CompressionSpec.from_books(
        books, "bf16", tensor_kind="act", mode=wire["mode"],
        transport="chunked", chunk=wire["chunk"], codec=wire["codec"],
        decode_backend=wire["decode_backend"])
    eng = Engine(params, cfg, ServeConfig(max_cache_len=cache_len), spec,
                 kv_mode=wire.get("kv_mode", "raw"), device=dev)
    rec = _Recorder(eng, tracer, new - 1, batch, cfg.vocab_size, ctx.seed,
                    dev, stale=bool(ctx.faults.get("stale_state")))
    if ctx.faults.get("alter_token"):
        sample = eng._sample

        def altered(logits):
            tok = sample(logits)
            tok[0] = (tok[0] + 1) % cfg.vocab_size
            return tok
        eng._sample = altered

    rec.start()                                     # warm-up: the shape
    eng.generate(warm_toks, new, prefix_embeds=warm_prefix)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    t_win = time.perf_counter()
    setup_s = t_win - ctx.t_start
    calls: List[Dict[str, Any]] = []
    while True:
        i = len(calls)
        toks, prefix = traffic.call(i)
        profiled = i == 1 and ctx.trace
        with tracer.slice() if profiled else contextlib.nullcontext():
            with tracer.span("serve.generate"):
                rec.start()
                t0 = time.perf_counter()
                out, totals = eng.generate(toks, new, prefix_embeds=prefix)
                t1 = time.perf_counter()
        calls.append({"wall_s": t1 - t0, "prompt_len": traffic.prompt_len,
                      "steps": [s["step_seconds"]
                                for s in eng.step_metrics],
                      "tokens": out, "traced": profiled,
                      "mismatch": totals["act_decode_mismatch"]})
        rec.end_call(i)
        if t1 - t_win >= ctx.seconds and len(calls) >= (3 if ctx.trace
                                                        else 1):
            break
    window_s = t1 - t_win
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)

    # ---- free the program's state, then the reference
    kept = rec.kept
    release(rec.step)
    if hasattr(rec.prefill, "release"):
        rec.prefill.release()
    del eng, rec
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check(ctx, params, traffic, calls, kept, warm_logits)
    ctx.info["reference_s"] = time.perf_counter() - t_ref
    steps = [s for c in calls if not c["traced"] for s in c["steps"]]
    ctx.info["step_ms_quantiles"] = [
        float(q) * 1e3 for q in np.percentile(steps, [5, 50, 90, 95, 99])]
    attempted = len(calls) * batch
    failed = sum(batch for c in calls
                 if c["mismatch"] or c["tokens"].shape != (batch, new))
    record = {"model": m, "batch": batch, "new_tokens": new,
              "prefix_len": npre, "cache_len": cache_len,
              "setup_s": setup_s, "window_s": window_s,
              "calls": [{k: v for k, v in c.items() if k != "tokens"}
                        for c in calls],
              "trace": tracer.summary}
    return {"record": record, "checks": checks, "attempted": attempted,
            "failed": failed, "memory_peak_bytes": peak}


def check(ctx, params, traffic, calls, kept, warm_logits) -> List[Dict]:
    dev, m, lim = ctx.device, ctx.model, ctx.check["limits"]
    model = importlib.import_module(
        f"perfbench.reference.{ctx.conf['reference']}")
    pairs = pick_requests(kept["call"], traffic.batch,
                          ctx.check["requests"], ctx.seed)
    toks, prefix = traffic.call(kept["call"])
    reqs = [{"prompt": toks[row],
             "served": torch.as_tensor(calls[ci]["tokens"][row],
                                       device=dev),
             "prefix": None if prefix is None else prefix[row],
             "logits": kept["logits"][:, row]} for ci, row in pairs]
    control = ctx.faults.get("control")
    gaps = served_gaps(model, params, m, reqs, control=control)
    lengths_ref = huffman.books_of(warm_logits)
    off = 0.0
    for s, met in enumerate(kept["metrics"]):
        want = huffman.coded_bits(kept["logits"][s], lengths_ref)
        off += abs(met["act_coded_bits"] - want) + abs(
            met["act_decoded_bits"] - want)
    over = max(sum(c["steps"]) - c["wall_s"] for c in calls) * 1e3
    numbers = dict(gap_numbers(gaps), wire_bits_off=off,
                   decode_mismatch=float(sum(c["mismatch"] for c in calls)),
                   steps_over_wall_ms=over)
    limits = dict(lim, wire_bits_off=0, decode_mismatch=0,
                  steps_over_wall_ms=0)
    ctx.info = {"tokens_compared": int(gaps["served"].size),
                "checked_call": kept["call"]}
    return compared(numbers, limits,
                    gap_numbers(gaps, "control") if control else None)
