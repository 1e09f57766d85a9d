"""Gradient-sync driver: data-parallel ranks on one ``LoopbackAxis``
all-reduce a whole model's bf16 gradient through the coded ring.

Set-up: weights from the seed; ``ranks + 1`` seeded train batches; one
backward pass (``loss_and_grads``) a batch.  The first batch's gradient
gives the books (a fixed book from an earlier batch); each other batch's
is one rank's payload, flattened (every leaf as bf16, in the tree's
leaf order) and cut into buckets of ``bucket`` elements, each a
contiguous (ranks, n) tensor.  One whole sync warms up every bucket
shape.  The window: whole-model syncs back to back, each ``ring_all_reduce``
over every bucket with no host sync between them and one at the end;
a traced run profiles the second sync whole, with a span around each
bucket and around the final wait.

After the window and the memory peak, for one sync drawn from the seed,
the reference (``reference.ring``: the uncoded ring, same hop schedule
and adds) is held to every bucket:

- ``sum_mismatch``: reduced elements whose bits differ from the
  reference's (exact);
- ``hop_bits_off``: each hop's ``hop_coded_bits`` against the
  reference's histogram · lengths of the values that hop ships, books
  worked out again from the first batch's gradient (exact).

The payloads are the program's own gradients (``loss_and_grads``): the
benchmark makes them once in set-up and hands the same tensors to the
ring and to the reference, which judges only what the ring made of
them.  With ``faults["control"]`` the control (the uncoded ring adding
in fp8) stands in the program's place in ``sum_mismatch``; ``faults``
also plant ``alter_answer`` (a reduced element's bit flipped) and
``no_exchange`` (the hop's exchange left out).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.lib.cell import model_config
from perfbench.lib.compare import compared, passed
from perfbench.lib.traffic import stream_seed, train_batches
from perfbench.lib.weights import make_params
from perfbench.reference import huffman
from perfbench.reference.ring import ring_all_reduce as plain_ring


_LOW = {"fp8": torch.float8_e4m3fn}


def _flat_grad(params, batch, cfg) -> torch.Tensor:
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.step import loss_and_grads
    _, _, grads = loss_and_grads(params, batch, cfg)
    return torch.cat([g.reshape(-1).to(torch.bfloat16)
                      for g in tree_leaves(grads)])


def run(ctx, tracer) -> Dict[str, Any]:
    from repro_torch.comm import LoopbackAxis, ring_all_reduce
    from repro_torch.comm.compression import histogram256
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import SCHEMES

    dev, tr, wire = ctx.device, ctx.traffic, ctx.workload["wire"]
    cfg = model_config(ctx.conf, ctx.overrides.get("model"))
    params = make_params(cfg, ctx.seed, dev)
    n, bucket = tr["ranks"], tr["bucket"]
    batches = train_batches(tr, cfg.vocab_size, ctx.seed, dev, count=n + 1)
    g0 = _flat_grad(params, batches[0], cfg)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("grad", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(g0).items()}
    ref_books = huffman.books_of(g0)        # worked out again, apart
    size = g0.numel()
    del g0
    spans = [(lo, min(bucket, size - lo)) for lo in range(0, size, bucket)]
    buckets = [torch.empty((n, k), dtype=torch.bfloat16, device=dev)
               for _, k in spans]
    for r in range(n):
        g = _flat_grad(params, batches[r + 1], cfg)
        for (lo, k), b in zip(spans, buckets):
            b[r].copy_(g[lo:lo + k])
        del g
    del params, batches
    ax = LoopbackAxis(n)
    if ctx.faults.get("no_exchange"):
        ax.ppermute = lambda tensors, shift: tensors
    cuda = dev.type == "cuda"

    def sync():
        outs = []
        for x in buckets:
            with tracer.span("sync.bucket"):
                y, st = ring_all_reduce(
                    x, ax, books, "bf16", chunk=wire["chunk"],
                    decode_backend=wire["decode_backend"],
                    carry=wire["carry"])
            if ctx.faults.get("alter_answer"):
                y.view(torch.int16)[0, 0] ^= 1
            outs.append((y, st["hop_coded_bits"]))
        with tracer.span("sync.wait"):
            if cuda:
                torch.cuda.synchronize()
        return outs

    sync()                                          # warm-up: every shape
    rng = np.random.default_rng(stream_seed(ctx.seed, 3))
    t_win = time.perf_counter()
    setup_s = t_win - ctx.t_start
    kept, syncs, sync_s = None, 0, []
    while True:
        profiled = syncs == 1 and ctx.trace
        t0 = time.perf_counter()
        with tracer.slice() if profiled else contextlib.nullcontext():
            outs = sync()
        t1 = time.perf_counter()
        sync_s.append((t1 - t0, profiled))
        if rng.random() < 1.0 / (syncs + 1):
            kept = (syncs, outs)
        del outs
        syncs += 1
        if t1 - t_win >= ctx.seconds and syncs >= (3 if ctx.trace else 1):
            break
    window_s = t1 - t_win
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    t_ref = time.perf_counter()
    checks, hop_bits = check(ctx, buckets, kept[1], ref_books)
    record = {"ranks": n, "size": size, "buckets": [k for _, k in spans],
              "hop_bits": hop_bits, "syncs": syncs,
              "sync_s": [t for t, traced in sync_s if not traced],
              "setup_s": setup_s, "window_s": window_s,
              "trace": tracer.summary}
    ctx.info = {"checked_sync": kept[0],
                "reference_s": time.perf_counter() - t_ref,
                "sync_ms_quantiles": [float(q) * 1e3 for q in np.percentile(
                    record["sync_s"], [5, 50, 95])]}
    failed = 0 if passed(checks) else syncs
    return {"record": record, "checks": checks, "attempted": syncs,
            "failed": failed, "memory_peak_bytes": peak}


def check(ctx, buckets: List[torch.Tensor], outs, ref_books):
    """(checks, hop bits): every bucket of the kept sync held to the
    uncoded ring; the hop bits (a rank's mean, each hop) as the
    reference counts them."""
    mismatch, off = 0, 0.0
    control = ctx.faults.get("control")
    control_mismatch = 0
    hop_bits = []
    for x, (y, hop) in zip(buckets, outs):
        want, shipped = plain_ring(x)
        mismatch += int((y.view(torch.int16) != want.view(torch.int16)
                         ).sum())
        ref = [huffman.coded_bits(s, ref_books) / x.shape[0]
               for s in shipped]
        got = hop.to(torch.float64).cpu().numpy()
        off += float(np.abs(got - np.asarray(ref)[None, :]).sum())
        hop_bits.append(ref)
        if control:
            low, _ = plain_ring(x, add_dtype=_LOW[control])
            control_mismatch += int((low.view(torch.int16)
                                     != want.view(torch.int16)).sum())
        del want, shipped
    numbers = {"sum_mismatch": float(mismatch), "hop_bits_off": off}
    return compared(numbers, {"sum_mismatch": 0, "hop_bits_off": 0},
                    {"sum_mismatch": float(control_mismatch)}
                    if control else None), hop_bits
