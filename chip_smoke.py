#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run (non-zero exit) on any fault:

1. device — require CUDA; print the card's name and power limit
   (``nvidia-smi``) and the torch version;
2. build  — compile the eight hand-written kernels (five sources in
   ``csrc/*.cu``, one ``nvcc`` per source, all at once) and print the
   build seconds;
3. kernels against their plain-torch versions, bit for bit, at the main
   path's shapes: the 1 024 000 symbols per byte plane of a batch-4
   ``gemma2-2b`` decode step (real logits of the warm-up prefill), plus
   an odd-chunk case (chunk 1001, an e4m3 plane), and B3 (with B1 and B2
   to code it) on ``w_gate[0]``'s hi plane (33.5 M symbols, 16 384
   chunks); each kernel is timed with CUDA events beside its plain
   version (and, for B1, the one-call gather ``lut[sym]`` as a yardstick
   the port never calls), and by the profiler's device events
   (``device_ms``: the device's own time a call, where the events loop
   also holds the host's), and B1's host time a call is read with
   ``time.perf_counter`` over calls that do not wait for the device
   (``host_us``); B1 and its yardstick, both host-bound, are read in
   turns and keep their least reading.  A chain probe (one thread, dependent shared-memory
   table lookups) measures the least time of one decode step, which
   bounds B3, B4 and B6-B8.
   The same for B5-B8 ("kernels vs plain (B5-B8)"): B5 (histogram) on
   the logits planes and on ``w_gate[0]``'s hi plane (33.5 M symbols),
   B6 (QLC decode) at chunk 2048 on the logits planes with QLC books from
   the same logits, B7/B8 (fused decode + matmul, Huffman / QLC) on three
   layer-0 matrices at full width (``w_down[0]`` at chunk 4096,
   ``w_gate[0]`` at chunk 16384, ``wo[0]`` as 2048 x 2048 at chunk 4096)
   with x = (4, K) bf16, the decode batch: decoded tiles bit for bit, the
   product within ``MATMUL_TOL`` of the plain version, and
   ``torch.matmul`` of the raw weight timed as the yardstick (each
   kernel and yardstick also by its device events);
4. serve ``gemma2-2b`` at full width: bf16 weights from a seeded
   generator, a warm-up prefill of 4 prompts x 64 tokens whose logits'
   byte-plane histograms build the books, then ``Engine.generate`` on 4
   new prompts x 64 tokens for 32 new tokens with a bitexact chunked spec,
   once with the ``multisym`` decode backend (kernel B4) and once with
   ``scan`` (kernel B3).  Every step must decode losslessly, code 2 x 500
   chunks, carry B2 chunk bits equal to histogram (B5) . lengths, and the
   kernels' launch counters must show the path ran through them;
5. coded-at-rest serve (``repro_torch.launch.dryrun.memstore_check`` at
   full width), under Huffman and QLC: the whole tree coded into a
   ``CompressedParamStore`` on the card, materialized bit for bit, the
   prompt's prefill cache through a ``CodedKVStore`` bit for bit, a decode
   step on it with bit-identical logits, and ``Engine(param_store=...,
   kv_mode="coded")`` generating the raw engine's 32 x 4 tokens; with its
   own launch counts (B1, B2, B4-B8 must all run);
6. the last lines: one ``{"kernels": [...]}`` record (B1-B8), then
   ``{"ok": true, "device": {...}}``.

``--profile`` adds a phase before the records: eight serve steps (no
wire, ``multisym``, ``scan``) under ``torch.profiler``, printing device
busy time per step, the idle share, the top kernels and the port's own
kernels (B1-B5 on this path) per step.

It needs a checkout of this repository around it (it imports
``src/repro_torch``) and a CUDA device; without either it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
BATCH, PROMPT, NEW = 4, 64, 32
CHUNK, ODD_CHUNK = 2048, 1001
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
INT32_LANES_PER_SM = 64          # Hopper SM: 4 partitions x 16 INT32 lanes
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
# B7/B8 against their plain versions: 0.  Both add the same exact
# float32 products (bf16 x bf16) in one fixed order with separate
# multiplies and adds, so any difference is a fault, not rounding.
MATMUL_TOL = 0.0

# The chain probe: one thread walks ``steps`` dependent lookups of the
# form a decoder's step takes at the least (shift, mask, shared-memory
# load), through a table that holds one random cycle over its entries.
CHAIN_PROBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void chain_kernel(const uint32_t* __restrict__ table, int size,
                             long long steps, uint32_t* sink) {
  extern __shared__ uint32_t s[];
  for (int i = threadIdx.x; i < size; i += blockDim.x) s[i] = table[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const uint32_t mask = static_cast<uint32_t>(size - 1);
  uint32_t v = s[0];
  for (long long i = 0; i < steps; ++i) v = s[(v >> 3) & mask];
  *sink = v;
}

extern "C" int chain_launch(const void* table, int size, long long steps,
                            void* sink, void* stream) {
  chain_kernel<<<1, 256, size * sizeof(uint32_t),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), size, steps,
      static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
"""


class SmokeError(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int):
    """(device ms a call, device events a call) of ``fn`` from
    torch.profiler's device events: the summed time of every kernel,
    memset and copy that ``reps`` calls (after one warm-up) launched, over
    ``reps``.  Unlike ``cuda_ms``, no host time is in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, events = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        us += e.self_cuda_time_total if t is None else t
        events += e.count
    return us / 1e3 / reps, events / reps


def host_us(torch, fn, reps: int = 200, rounds: int = 3) -> float:
    """Host time of one call of ``fn`` in microseconds: the least of
    ``rounds`` perf_counter readings over ``reps`` calls with no sync
    (the device runs behind), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return best * 1e6


def interleaved(fns, measure, rounds: int = 5):
    """The least of ``rounds`` readings of ``measure(fn)`` for each of
    ``fns``, taken in turns (A, B, A, B, ...), so that a slow spell of
    the host falls on all of them alike."""
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], measure(fn))
    return best


def compare(torch, got, want):
    """(mismatching elements, max |difference|) over tensor tuples, with
    int32 words compared as their unsigned values."""
    bad, err = 0, 0
    for g, w in zip(got, want):
        g64 = g.to(torch.int64)
        w64 = w.to(torch.int64)
        if g.dtype == torch.int32:
            g64, w64 = g64 & 0xFFFFFFFF, w64 & 0xFFFFFFFF
        d = (g64 - w64).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()) if d.numel() else 0)
    return bad, err


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py needs the repository around it "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2

    from repro_torch.comm.compression import CompressionSpec, histogram256
    from repro_torch.configs import get_config
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import (chunk_capacity_words,
                                          chunk_counts_for, concat_chunks)
    from repro_torch.core.symbols import SCHEMES
    from repro_torch.kernels import bitpack, build, decode, encode
    from repro_torch.launch.dryrun import memstore_check
    from repro_torch.models import (decode_step, forward, model_init,
                                    param_count, prefill)
    from repro_torch.serve import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---------------------------------------------------------- 1. device
    phase("device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    name = torch.cuda.get_device_name(0)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * INT32_LANES_PER_SM * max_sm_mhz * 1e6
    print(card)                             # as nvidia-smi gives it
    print(f"{sms} SMs, max SM clock {max_sm_mhz} MHz: INT32 peak "
          f"{int_ops_per_s:.4e} op/s")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} x{torch.cuda.device_count()}")

    # ----------------------------------------------------------- 2. build
    phase("build")
    t0 = time.perf_counter()
    probe_job = start_chain_probe(build)
    try:
        libs = build.build_all()
    except BaseException:
        probe_job[0].kill()
        probe_job[0].wait()
        raise
    probe = finish_chain_probe(probe_job)
    print(f"built {sorted(libs)} and the chain probe in "
          f"{time.perf_counter() - t0:.3f} s")
    for src, log in sorted(build.build_logs().items()):
        for line in log.splitlines():       # -Xptxas -v, kernel by kernel
            fn = re.search(r"entry function '\w*?\d+(\w+_kernel)", line)
            if fn:
                print(f"  ptxas {src} {fn.group(1)}:")
            elif "registers" in line or "spill" in line:
                print(f"    {line.replace('ptxas info    :', '').strip()}")

    # ------------------------------- 4a. model + warm-up prefill (books)
    phase("gemma2-2b init + warm-up prefill")
    cfg = get_config("gemma2-2b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
        torch.cuda.synchronize()
        print(f"params: {param_count(params) / 1e9:.4f} B "
              f"in {time.perf_counter() - t0:.1f} s")
        warm = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                             generator=gen, device=dev)
        logits, _ = prefill(params, {"tokens": warm}, cfg, PROMPT + NEW)
    planes = SCHEMES["bf16"].to_symbols(logits)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in planes.items()}
    for p, b in books.items():
        print(f"book {p}: lengths {int(b.lengths.min())}.."
              f"{int(b.lengths.max())}")
    step_logits = logits[:, -1].to(torch.bfloat16)      # one decode step's
    need(bool(torch.isfinite(step_logits.float()).all()), "warm-up logits "
         "are not finite")

    # -------------------------------------- 3. kernels vs plain versions
    phase("kernels vs plain")
    stats = {k: {"mismatches": 0, "max_abs_err": 0} for k in
             ("encode_lookup", "pack_blocks", "decode_chunks_canonical",
              "decode_chunks_multisym")}

    def record(kname, got, want):
        bad, err = compare(torch, got, want)
        stats[kname]["mismatches"] += bad
        stats[kname]["max_abs_err"] = max(stats[kname]["max_abs_err"], err)

    def check_case(tag, sym_planes, case_books, chunk, time_it):
        enc, timing = {}, {}
        for p, sym in sym_planes.items():
            b = case_books[p]
            (lut,) = b.device_tables("lut", dev)
            k1 = encode.encode_lookup(sym, lut)
            record("encode_lookup", k1, encode.encode_lookup_plain(sym, lut))
            k2 = bitpack.pack_blocks(k1[0], k1[1], chunk=chunk)
            record("pack_blocks", k2, bitpack.pack_blocks_plain(
                k1[0], k1[1], chunk=chunk))
            n = sym.numel()
            counts = torch.from_numpy(chunk_counts_for(n, chunk)).to(dev)
            canon = b.device_tables("canonical", dev)
            ms = b.device_tables("multisym", dev)
            (pre,) = b.device_tables("prefix", dev)
            k3 = decode.decode_chunks_canonical(k2[0], counts, *canon,
                                                chunk=chunk, prefix=pre)
            record("decode_chunks_canonical", (k3,),
                   (decode.decode_chunks_canonical_plain(
                       k2[0], counts, *canon, chunk=chunk),))
            k4 = decode.decode_chunks_multisym(k2[0], counts, *ms, *canon,
                                               chunk=chunk)
            record("decode_chunks_multisym", (k4,),
                   (decode.decode_chunks_multisym_plain(
                       k2[0], counts, *ms, *canon, chunk=chunk),))
            cc = chunk_counts_for(n, chunk)
            need(torch.equal(concat_chunks(k4, cc), sym) and
                 torch.equal(concat_chunks(k3, cc), sym),
                 f"{tag}/{p}: kernels do not round-trip the plane")
            enc[p] = (sym, lut, k1, k2, counts, canon, ms, pre)
        print(f"{tag}: chunk {chunk}, {len(sym_planes)} plane(s) x "
              f"{next(iter(sym_planes.values())).numel()} symbols, "
              f"mismatches so far "
              f"{sum(s['mismatches'] for s in stats.values())}")
        if not time_it:
            return enc, timing
        np_ = len(enc)
        each = list(enc.values())

        def over(fn):
            return lambda: [fn(*e) for e in each]

        b1 = over(lambda s, lut, *_: encode.encode_lookup(s, lut))
        b1_lib = over(lambda s, lut, *_: lut[s.long()])
        b2 = over(lambda s, lut, k1, *_: bitpack.pack_blocks(
            k1[0], k1[1], chunk=chunk))
        b3 = over(lambda s, l, k1, k2, c, canon, ms, pre:
                  decode.decode_chunks_canonical(k2[0], c, *canon,
                                                 chunk=chunk, prefix=pre))
        b4 = over(lambda s, l, k1, k2, c, canon, ms, pre:
                  decode.decode_chunks_multisym(k2[0], c, *ms, *canon,
                                                chunk=chunk))
        # B1 and its yardstick are host-bound: both are read in turns
        ms1, lib1 = interleaved((b1, b1_lib),
                                lambda f: cuda_ms(torch, f, 50) / np_)
        host1, lib_host1 = interleaved((b1, b1_lib),
                                       lambda f: host_us(torch, f, rounds=1)
                                       / np_)
        timing["encode_lookup"] = dict(
            ms=ms1,
            plain_ms=cuda_ms(torch, over(
                lambda s, lut, *_: encode.encode_lookup_plain(s, lut)),
                20) / np_,
            library_ms=lib1, host_us=host1, library_host_us=lib_host1)
        timing["pack_blocks"] = dict(
            ms=cuda_ms(torch, b2, 50) / np_,
            plain_ms=cuda_ms(torch, over(
                lambda s, lut, k1, *_: bitpack.pack_blocks_plain(
                    k1[0], k1[1], chunk=chunk)), 10) / np_,
            library_ms=None)
        timing["decode_chunks_canonical"] = dict(
            ms=cuda_ms(torch, b3, 10) / np_,
            plain_ms=cuda_ms(torch, over(
                lambda s, l, k1, k2, c, canon, *_:
                decode.decode_chunks_canonical_plain(
                    k2[0], c, *canon, chunk=chunk)), 1) / np_,
            library_ms=None)
        timing["decode_chunks_multisym"] = dict(
            ms=cuda_ms(torch, b4, 10) / np_,
            plain_ms=cuda_ms(torch, over(
                lambda s, l, k1, k2, c, canon, ms, pre:
                decode.decode_chunks_multisym_plain(
                    k2[0], c, *ms, *canon, chunk=chunk)), 1) / np_,
            library_ms=None)
        for k, fn, lib, reps in (("encode_lookup", b1, b1_lib, 50),
                                 ("pack_blocks", b2, None, 50),
                                 ("decode_chunks_canonical", b3, None, 10),
                                 ("decode_chunks_multisym", b4, None, 10)):
            d_ms, events = device_ms(torch, fn, reps)
            timing[k].update(device_ms=d_ms / np_,
                             device_events_per_call=events / np_,
                             library_device_ms=(device_ms(torch, lib, reps)[0]
                                                / np_ if lib else None))
        return enc, timing

    main_enc, timing = check_case("main path (bf16 logits)",
                                  SCHEMES["bf16"].to_symbols(step_logits),
                                  books, CHUNK, time_it=True)
    odd = SCHEMES["e4m3"].to_symbols(step_logits.float())
    odd_books = {p: build_codebook(histogram256(s).cpu().numpy())
                 for p, s in odd.items()}
    check_case("odd chunk (e4m3 plane)", odd, odd_books, ODD_CHUNK,
               time_it=False)
    b3_store = check_b3_store_plane(torch, dev, params, int_ops_per_s, sms)
    stats["decode_chunks_canonical"]["mismatches"] += b3_store["mismatches"]
    for k, s in stats.items():
        need(s["mismatches"] == 0, f"kernel {k} disagrees with its plain "
             f"version: {s}")
    step_ns = chain_step_ns(torch, probe, dev)
    print(f"chain probe: {step_ns:.3f} ns per dependent lookup step [{card}]")
    b3_store.update(chain_step_ns=step_ns,
                    chain_bound_ms=CHUNK * step_ns * 1e-6)
    b3_fields = dict(ns_per_step=timing["decode_chunks_canonical"]["ms"]
                     * 1e6 / CHUNK,
                     **b3_launch_shape(main_enc["lo"][3][0].shape[0], sms))
    for tag, r in (("logits plane", dict(timing["decode_chunks_canonical"],
                                         **b3_fields)),
                   ("w_gate[0] hi plane", b3_store)):
        print(f"  decode_chunks_canonical {tag}: {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}), {r['ns_per_step']:.2f} ns a step, "
              f"{r['chunks_per_cta']} chunks a CTA, {r['ctas']} CTAs, "
              f"{r['ctas_per_sm']} a SM, {r['waves']} wave(s) [{card}]")
    t = timing["encode_lookup"]
    print(f"  encode_lookup: {t['ms']:.5f} ms a call (device "
          f"{t['device_ms']:.5f}, {t['device_events_per_call']:g} device "
          f"events a call, host {t['host_us']:.2f} us), lut[s.long()] "
          f"{t['library_ms']:.5f} ms (device {t['library_device_ms']:.5f}, "
          f"host {t['library_host_us']:.2f} us) [{card}]")

    phase("kernels vs plain (B5-B8)")
    t0 = time.perf_counter()
    new_kernels = check_b5_to_b8(torch, dev, params, step_logits,
                                 int_ops_per_s, step_ns, sms)
    for k, r in new_kernels.items():
        print(f"{k}: mismatches {r['mismatches']}, max abs err "
              f"{r['max_abs_err']}, {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}, plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}) [{card}]")
        need(r["mismatches"] == 0, f"kernel {k} disagrees with its plain "
             f"version: {r['mismatches']} mismatching elements")
    for k in ("decode_matmul", "decode_matmul_qlc"):
        for tag, r in new_kernels[k]["by_matrix"].items():
            print(f"  {k} {tag}: {r['ms']:.4f} ms (device "
                  f"{r['device_ms']:.4f}), {r['chain_steps']} chain "
                  f"steps, {r['ns_per_step']:.2f} ns a step, {r['ctas']} "
                  f"CTAs, {r['ctas_per_sm']} a SM, {r['waves']} wave(s), "
                  f"chain bound {r['chain_bound_ms']:.4f} ms, x @ w "
                  f"{r['library_ms']:.4f} ms [{card}]")
        for tag, r in new_kernels[k]["extra_cases"].items():
            print(f"  {k} {tag}: tiles exact, product max abs err vs "
                  f"plain {r['max_abs_err']}, rel err vs dense "
                  f"{r['rel_err_vs_dense']:.3e}, longest codes "
                  f"{r['max_code_len']}")
    print(f"B5-B8 phase: {time.perf_counter() - t0:.1f} s")

    # ---------------------------------------------- 4b. serve at full width
    phase("serve gemma2-2b (bitexact wire)")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    runs, specs = {}, {}
    expect_kernel = {"multisym": "decode_chunks_multisym",
                     "scan": "decode_chunks_canonical"}
    n_sym = BATCH * cfg.vocab_size
    chunks_per_step = 2 * len(chunk_counts_for(n_sym, CHUNK))
    build.reset_launches()                  # the main path's count starts
    for backend in ("multisym", "scan"):
        spec = CompressionSpec.from_books(books, "bf16", tensor_kind="act",
                                          mode="bitexact",
                                          transport="chunked", chunk=CHUNK,
                                          decode_backend=backend)
        specs[backend] = spec
        eng = Engine(params, cfg, ServeConfig(max_cache_len=PROMPT + NEW),
                     spec, device=dev)
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        toks, totals = eng.generate(prompts, NEW)
        wall = time.perf_counter() - t0
        grew = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
        steps = eng.step_metrics
        need(toks.shape == (BATCH, NEW), f"tokens shape {toks.shape}")
        need(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token ids")
        need(len(steps) == NEW - 1, f"{len(steps)} decode steps")
        need(totals["act_decode_mismatch"] == 0.0,
             f"{backend}: {totals['act_decode_mismatch']} mismatches")
        need(totals["act_decode_chunks"] == chunks_per_step * (NEW - 1),
             f"{backend}: {totals['act_decode_chunks']} chunks")
        for i, m in enumerate(steps):
            need(m["act_decoded_bits"] == m["act_coded_bits"] > 0,
                 f"{backend} step {i}: B2 bits {m['act_decoded_bits']} != "
                 f"histogram . lengths {m['act_coded_bits']}")
        for k in ("encode_lookup", "pack_blocks", "histogram256",
                  expect_kernel[backend]):
            need(grew[k] > 0, f"{backend}: kernel {k} was not launched")
        step_s = sorted(m["step_seconds"] for m in steps)
        med = step_s[len(step_s) // 2]
        tail = len(step_s) - 11             # ten samples beyond it
        runs[backend] = {"decode_steps": len(step_s),
                         "decode_step_ms_median": med * 1e3,
                         "decode_step_ms_min": step_s[0] * 1e3,
                         "decode_step_ms_tail": step_s[tail] * 1e3,
                         "tail_percentile": 100.0 * (tail + 1) / len(step_s),
                         "tokens_per_s": BATCH / med,
                         "generate_s": wall, "launches": grew,
                         "coded_bits_per_step": totals["act_coded_bits"]
                         / (NEW - 1),
                         "raw_bits_per_step": totals["act_raw_bits"]
                         / (NEW - 1)}
        print(f"{backend}: decode step {med * 1e3:.3f} ms (median of "
              f"{len(steps)}), {BATCH / med:.1f} tokens/s, coded/raw "
              f"{totals['act_coded_bits'] / totals['act_raw_bits']:.4f}, "
              f"launches {grew} [{card}]")
    launches = dict(build.LAUNCHES)         # read right after the main path

    # The serve step itself must not wait for the device: Engine.generate
    # takes the step's one host sync when it reads the metrics.
    for backend, spec in specs.items():
        step_without_sync(torch, params, cfg, prompts, spec)
    print("serve step: no host sync inside (torch sync debug mode 'error')")

    # The same engine without a spec: the model's own step time.
    eng = Engine(params, cfg, ServeConfig(max_cache_len=PROMPT + NEW),
                 device=dev)
    eng.generate(prompts, 8)
    bare = sorted(m["step_seconds"] for m in eng.step_metrics)
    runs["no_wire"] = {"decode_step_ms_median": bare[len(bare) // 2] * 1e3}
    print(f"no wire: decode step "
          f"{runs['no_wire']['decode_step_ms_median']:.3f} ms [{card}]")

    # Output check on a small input: one decode step after a prefill
    # agrees with the full-sequence forward at full width (bf16).
    with torch.no_grad():
        seq = prompts[:1, :9]
        full = forward(params, {"tokens": seq}, cfg)[:, -1].float()
        _, caches = prefill(params, {"tokens": seq[:, :8]}, cfg, 16)
        one, _ = decode_step(params, seq[:, 8:9], caches, 8, cfg)
        one = one[:, 0].float()
    rel = float((one - full).abs().max() / full.abs().max())
    need(bool(torch.isfinite(one).all()) and rel < 5e-2,
         f"decode step vs forward: rel err {rel}")
    print(f"decode step vs full forward (bf16, full width): max rel err {rel}")

    # ---------------------------------- 5. coded-at-rest serve (B1-B8)
    phase("coded-at-rest serve (huffman, qlc)")
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()                  # this path's count starts
    coded = memstore_check(cfg, params, device=dev, batch=BATCH,
                           prompt_len=PROMPT, new_tokens=NEW)
    coded_launches = dict(build.LAUNCHES)   # read right after the path
    coded["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({"card": card, "coded_at_rest": coded}))
    need(coded["status"] == "ok", "coded-at-rest serve: a check failed "
         "(see the record above)")
    for codec in ("huffman", "qlc"):
        r = coded[codec]
        need(r["coded_steps"] == NEW - 1, f"{codec}: {r['coded_steps']} "
             f"coded decode steps")
        print(f"{codec}: param ratio {r['param_hbm_ratio']:.4f}, kv ratio "
              f"{r['kv_hbm_ratio']:.4f}, coded step "
              f"{r['coded_step_ms_median']:.3f} ms (median), one step "
              f"{r['one_coded_step']} [{card}]")
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym", "decode_chunks_qlc", "decode_matmul",
              "decode_matmul_qlc"):
        need(coded_launches[k] > 0, f"coded-at-rest serve: kernel {k} was "
             f"not launched")
    print(f"coded-at-rest launches {coded_launches}, peak memory "
          f"{coded['peak_memory_gb']:.2f} GB [{card}]")

    if "--profile" in sys.argv[1:]:
        phase("profile (torch.profiler, device timeline)")
        prof = {k: profile_steps(torch, params, cfg, prompts, spec)
                for k, spec in (("no_wire", None), *specs.items())}
        print(json.dumps({"card": card, "profile": prof}))

    # ------------------------------------------------------- 5. records
    source = "src/repro_torch/kernels/csrc/"
    meta = {
        "encode_lookup": ("B1", "encode.cu", "src/repro/kernels/encode.py:65"),
        "pack_blocks": ("B2", "bitpack.cu", "src/repro/kernels/bitpack.py:60"),
        "decode_chunks_canonical": ("B3", "decode.cu",
                                    "src/repro/kernels/decode.py:101"),
        "decode_chunks_multisym": ("B4", "decode.cu",
                                   "src/repro/kernels/decode.py:218"),
    }
    bounds = kernel_bounds(torch, main_enc, CHUNK, chunk_capacity_words,
                           int_ops_per_s, step_ns)
    kernels = []
    for k, (tag, src, replaces) in meta.items():
        t = dict(timing[k])
        bound_s, bound_by, extra = bounds[k]
        if k == "decode_chunks_canonical":     # B7's fields, and the store
            extra = dict(extra, **b3_fields, store_plane=b3_store)  # plane
        kernels.append({
            "name": f"{tag} {k}", "route": "cuda", "source": source + src,
            "replaces": replaces,
            "launches": launches[k] + coded_launches[k],
            "launches_by_path": {"wire_serve": launches[k],
                                 "coded_at_rest": coded_launches[k]},
            "mismatches": stats[k]["mismatches"],
            "max_abs_err": stats[k]["max_abs_err"],
            "ms": t.pop("ms"), "plain_ms": t.pop("plain_ms"),
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": t.pop("library_ms"), **t, **extra})
    new_meta = {
        "histogram256": ("B5", "histogram.cu",
                         "src/repro/kernels/histogram.py:47"),
        "decode_chunks_qlc": ("B6", "decode.cu",
                              "src/repro/kernels/decode.py:333"),
        "decode_matmul": ("B7", "decode_matmul.cu",
                          "src/repro/kernels/decode_matmul.py:203"),
        "decode_matmul_qlc": ("B8", "decode_matmul.cu",
                              "src/repro/kernels/decode_matmul.py:264"),
    }
    for k, (tag, src, replaces) in new_meta.items():
        r = dict(new_kernels[k])
        kernels.append({
            "name": f"{tag} {k}", "route": "cuda", "source": source + src,
            "replaces": replaces,
            "launches": launches[k] + coded_launches[k],
            "launches_by_path": {"wire_serve": launches[k],
                                 "coded_at_rest": coded_launches[k]},
            **r})
    print(json.dumps({"card": card, "serve": runs}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def timed_once(torch, fn):
    """(result, device ms) of one call of ``fn``, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def least_ms(nbytes, int_ops, int_ops_per_s, flops=0.0):
    """(bound ms, by): the larger of bytes over the HBM rate and the
    operations over the card's peak rates (INT32 lanes, bf16 tensor
    cores for products of bf16 inputs)."""
    tb = nbytes / HBM_BYTES_PER_S
    to = int_ops / int_ops_per_s + flops / BF16_FLOP_PER_S
    return (tb * 1e3, "bytes") if tb >= to else (to * 1e3, "operations")


def used_words(bits):
    """Words a decoder must read: each chunk's payload plus its pad."""
    return int(((bits.long() + 31) // 32 + 1).sum())


def b3_launch_shape(nb: int, sms: int) -> dict:
    """B3's launch for ``nb`` chunks, as its C entry chooses it: chunks
    (walker lanes) a CTA, walker warps a CTA, CTAs, dynamic shared memory
    a CTA, CTAs an SM holds at once, and waves."""
    import ctypes
    from repro_torch.kernels.build import I, P, bind
    shape = (ctypes.c_int * 5)()
    err = bind("decode", "decode_canonical_shape", [I, P])(
        nb, ctypes.addressof(shape))
    need(err == 0, f"B3 launch-shape query failed ({err})")
    per_cta, warps, ctas, smem, per_sm = list(shape)
    need(per_sm > 0, "B3: no CTA fits an SM")
    return {"chunks_per_cta": per_cta, "walker_warps_per_cta": warps,
            "ctas": ctas, "smem_bytes_per_cta": smem, "ctas_per_sm": per_sm,
            "waves": -(-ctas // (per_sm * sms))}


def check_b3_store_plane(torch, dev, params, int_ops_per_s, sms) -> dict:
    """B3 on ``w_gate[0]``'s hi plane (33.5 M symbols: 16 384 chunks at
    CHUNK, far more than SMs), with a book from the plane's own counts:
    coded by B1 + B2, decoded by B3 and by its plain version, held bit for
    bit and to the plane, and timed (CUDA events, the profiler)."""
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import (PREFIX_BITS, chunk_counts_for,
                                          concat_chunks)
    from repro_torch.core.symbols import bf16_planes
    from repro_torch.kernels import decode, histogram, ops
    t0 = time.perf_counter()
    sym = bf16_planes(params["groups"][0][0]["ffn"]["w_gate"][0])["hi"]
    hist = histogram.histogram256(sym).cpu()
    book = build_codebook(hist.numpy())
    words, bits = ops.encode_with_book(sym, book, chunk=CHUNK)
    cc = chunk_counts_for(sym.numel(), CHUNK)
    counts = torch.from_numpy(cc).to(dev)
    canon = book.device_tables("canonical", dev)
    (pre,) = book.device_tables("prefix", dev)

    def run():
        return decode.decode_chunks_canonical(words, counts, *canon,
                                              chunk=CHUNK, prefix=pre)

    got = run()
    want, plain_ms = timed_once(torch, lambda: (
        decode.decode_chunks_canonical_plain(words, counts, *canon,
                                             chunk=CHUNK)))
    bad = int((got != want).sum())
    need(torch.equal(concat_chunks(got, cc), sym), "B3 w_gate[0] hi plane: "
         "the kernel does not round-trip the plane")
    ms = cuda_ms(torch, run, 10)
    d_ms, _ = device_ms(torch, run, 10)
    nb, n = words.shape[0], sym.numel()
    nbits = int(bits.to(torch.int64).sum())
    bound, by = least_ms(used_words(bits) * 4 + nb * 4 + (3 * 17 + 256) * 4
                         + 2 * (1 << PREFIX_BITS) + nb * CHUNK * 4,
                         8 * n + 5 * nbits, int_ops_per_s)
    slow = torch.from_numpy(book.lengths > PREFIX_BITS)
    print(f"B3 w_gate[0] hi plane: {n} symbols, {nb} chunks, mismatches "
          f"{bad}, codes {int(book.lengths.min())}..{int(book.lengths.max())}"
          f" bits ({time.perf_counter() - t0:.1f} s)")
    return {"symbols": n, "chunks": nb, "mismatches": bad, "ms": ms,
            "device_ms": d_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "chain_steps_per_chunk": CHUNK,
            "ns_per_step": ms * 1e6 / CHUNK,
            "max_code_len": int(book.lengths.max()),
            "slow_step_share": float(hist[slow].sum() / n),
            **b3_launch_shape(nb, sms)}


def check_b5_to_b8(torch, dev, params, step_logits, int_ops_per_s,
                   step_ns, sms):
    """B5-B8 against their plain versions at the main path's shapes (see
    the module docstring), each timed by CUDA events beside its plain
    version and its yardstick.  Returns kernel -> its record fields."""
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import chunk_counts_for, concat_chunks
    from repro_torch.core.qlc import qlc_kernel_args
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.kernels import decode, histogram, ops
    from repro_torch.kernels import decode_matmul as dm
    from repro_torch.memstore import CompressedParamStore

    out = {}
    planes = SCHEMES["bf16"].to_symbols(step_logits)
    layer0 = params["groups"][0][0]
    w_gate0 = layer0["ffn"]["w_gate"][0]

    # ---- B5: exact 256-bin counts
    cases = dict(planes)
    cases["w_gate[0] hi"] = bf16_planes(w_gate0)["hi"]
    bad = err = 0
    for tag, sym in cases.items():
        got, want = histogram.histogram256(sym), histogram.histogram256_plain(
            sym)
        d = (got - want).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()))
        need(int(got.sum()) == sym.numel(), f"B5 {tag}: counts sum "
             f"{int(got.sum())} != {sym.numel()}")
    each = list(planes.values())
    n = each[0].numel()
    ms = cuda_ms(torch, lambda: [histogram.histogram256(s) for s in each],
                 50) / 2
    plain_ms = cuda_ms(torch, lambda: [histogram.histogram256_plain(s)
                                       for s in each], 20) / 2
    lib_ms = cuda_ms(torch, lambda: [torch.bincount(s, minlength=256)
                                     for s in each], 50) / 2
    dev_ms = device_ms(torch, lambda: [histogram.histogram256(s)
                                       for s in each], 50)[0] / 2
    lib_dev_ms = device_ms(torch, lambda: [torch.bincount(s, minlength=256)
                                           for s in each], 50)[0] / 2
    gate_hi = cases["w_gate[0] hi"]
    gate_ms = cuda_ms(torch, lambda: histogram.histogram256(gate_hi), 20)
    bound, by = least_ms(n + 256 * 8, 2 * n, int_ops_per_s)
    gate_bound, _ = least_ms(gate_hi.numel() + 256 * 8, 2 * gate_hi.numel(),
                             int_ops_per_s)
    out["histogram256"] = {
        "mismatches": bad, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
        "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
        "symbols": n, "w_gate0_hi_symbols": gate_hi.numel(),
        "w_gate0_hi_ms": gate_ms, "w_gate0_hi_bound_ms": gate_bound}

    # ---- B6: QLC decode at chunk 2048, books from the same logits
    books = {p: build_codebook(histogram.histogram256(s).cpu().numpy(),
                               codec="qlc", key=("act", "bf16", p))
             for p, s in planes.items()}
    enc = []
    bad = err = 0
    for p, sym in planes.items():
        words, bits = ops.encode_with_book(sym, books[p], chunk=CHUNK)
        cc = chunk_counts_for(sym.numel(), CHUNK)
        counts = torch.from_numpy(cc).to(dev)
        args = qlc_kernel_args(books[p], dev)
        k6 = decode.decode_chunks_qlc(words, counts, *args, chunk=CHUNK)
        p6 = decode.decode_chunks_qlc_plain(words, counts, *args, chunk=CHUNK)
        d = (k6.to(torch.int64) - p6.to(torch.int64)).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()))
        need(torch.equal(concat_chunks(k6, cc), sym), f"B6 {p}: the QLC "
             f"stream does not round-trip the plane")
        enc.append((words, counts, args, bits))
    ms = cuda_ms(torch, lambda: [decode.decode_chunks_qlc(
        w, c, *a, chunk=CHUNK) for w, c, a, _ in enc], 10) / 2
    dev_ms = device_ms(torch, lambda: [decode.decode_chunks_qlc(
        w, c, *a, chunk=CHUNK) for w, c, a, _ in enc], 10)[0] / 2
    _, plain_ms = timed_once(torch, lambda: [decode.decode_chunks_qlc_plain(
        w, c, *a, chunk=CHUNK) for w, c, a, _ in enc])
    nb = enc[0][0].shape[0]
    words_read = sum(used_words(b) for *_, b in enc) / 2
    bound, by = least_ms(words_read * 4 + nb * 4 + 256 * 4 + nb * CHUNK * 4,
                         16 * n, int_ops_per_s)
    out["decode_chunks_qlc"] = {
        "mismatches": bad, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms / 2, "bound_ms": bound, "bound_by": by,
        "library_ms": None, "device_ms": dev_ms, "library_device_ms": None,
        "chain_steps_per_chunk": CHUNK,
        "chain_step_ns": step_ns, "chain_bound_ms": CHUNK * step_ns * 1e-6,
        "symbols": n, "chunks": nb,
        "qlc_class_lengths": {p: b.class_lengths for p, b in books.items()}}

    # ---- B7 / B8: fused decode + matmul on three layer-0 matrices
    import ctypes
    from repro_torch.core.encoder import PREFIX_BITS
    from repro_torch.kernels.build import I as C_INT, P as C_PTR, bind
    d_model = w_gate0.shape[0]
    mats = {"w_down[0]": (layer0["ffn"]["w_down"][0], 4096),
            "w_gate[0]": (w_gate0, 16384),
            "wo[0]": (layer0["mixer"]["wo"][0].reshape(-1, d_model), 4096)}
    gen = torch.Generator().manual_seed(SEED + 1)
    xs = {tag: torch.randn((BATCH, w.shape[0]), generator=gen).to(
              torch.bfloat16).to(dev) for tag, (w, _) in mats.items()}
    # The slow-path case: a 2048 x 2048 weight whose lo bytes follow a
    # geometric law (byte k with weight 2^(-k/16)), so the lo book codes
    # the rare bytes in more than PREFIX_BITS bits (about 0.4 % of the lo
    # steps take the canonical search); and two decode batches whose M is
    # no multiple of anything the kernel tiles (M = 1 and M = 37) on wo[0].
    skew = (torch.randn((2048, 2048), generator=gen) * 0.02).to(
        torch.bfloat16).view(torch.int16)
    lo_byte = torch.clamp(-torch.log2(torch.rand((2048, 2048),
                                                 generator=gen)) * 16,
                          max=255).floor().to(torch.int16)
    skew = ((skew & -256) | lo_byte).view(torch.bfloat16).to(dev)
    extra = {"slow path (2048 x 2048, geometric lo bytes)":
             (skew, 4096, torch.randn((BATCH, 2048), generator=gen)),
             "wo[0], M = 1": (mats["wo[0]"][0], 4096,
                              torch.randn((1, 2048), generator=gen)),
             "wo[0], M = 37": (mats["wo[0]"][0], 4096,
                               torch.randn((37, 2048), generator=gen))}
    occupancy = bind("decode_matmul", "decode_matmul_occupancy",
                     [C_INT, C_PTR])
    for codec, kname, kern, plain in (
            ("huffman", "decode_matmul", dm.decode_matmul,
             dm.decode_matmul_plain),
            ("qlc", "decode_matmul_qlc", dm.decode_matmul_qlc,
             dm.decode_matmul_qlc_plain)):
        per_sm = ctypes.c_int(0)
        err = occupancy(int(codec == "qlc"), ctypes.addressof(per_sm))
        need(err == 0, f"{kname}: occupancy query failed ({err})")
        ctas_per_sm = per_sm.value
        rec = {"mismatches": 0, "max_abs_err": 0.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "device_ms": 0.0, "library_device_ms": 0.0,
               "chain_bound_ms": 0.0, "chain_step_ns": step_ns,
               "tolerance": MATMUL_TOL, "ctas_per_sm": ctas_per_sm,
               "by_matrix": {}, "extra_cases": {}}

        def run_case(tag, w, chunk, x):
            """Code w into a store, run the kernel and its plain version
            with tiles, check both; returns (store, blocks, args)."""
            k_rows, n_cols = w.shape
            st = CompressedParamStore.from_tree({"w": w}, codec=codec,
                                                chunk=chunk, min_size=1,
                                                device=dev)
            lo, hi, counts = st.plane_blocks("w")
            tabs = ops.decode_matmul_tables(st.books, dev)
            kw = dict(chunk=chunk, n_cols=n_cols)
            if codec == "huffman":
                kw["prefix"] = ops.decode_matmul_prefix(st.books, dev)
            y, tiles = kern(x, lo, hi, counts, *tabs, tiles=True, **kw)
            kw.pop("prefix", None)
            (yp, tp), p_ms = timed_once(torch, lambda: plain(
                x, lo, hi, counts, *tabs, tiles=True, **kw))
            t_bad = int((tiles.view(torch.int16)
                         != tp.view(torch.int16)).sum())
            need(torch.equal(tiles.reshape(-1)[:w.numel()].view(torch.int16),
                             w.reshape(-1).view(torch.int16)),
                 f"{kname} {tag}: decoded tiles are not the weight")
            y_err = float((y - yp).abs().max())
            need(y_err <= MATMUL_TOL, f"{kname} {tag}: product differs "
                 f"from the plain version by {y_err} > {MATMUL_TOL}")
            dense = (x.float() @ w.float())
            rel = float((y - dense).abs().max() / dense.abs().max())
            need(rel < 1e-4, f"{kname} {tag}: product vs dense rel err {rel}")
            rec["mismatches"] += t_bad
            rec["max_abs_err"] = max(rec["max_abs_err"], y_err)
            lens = {p: int(b.lengths.max()) if codec == "huffman" else
                    max(b.class_lengths) for p, b in st.books.items()}
            r = {"shape": [k_rows, n_cols], "m": x.shape[0], "chunk": chunk,
                 "chunks": lo.shape[0], "plain_ms": p_ms,
                 "tile_mismatches": t_bad, "max_abs_err": y_err,
                 "rel_err_vs_dense": rel, "max_code_len": lens}
            if codec == "huffman":      # lo steps that take the slow path
                cnt = torch.bincount((w.view(torch.int16) & 0xFF).reshape(
                    -1).long(), minlength=256).cpu()
                slow = torch.from_numpy(st.books["lo"].lengths > PREFIX_BITS)
                r["lo_slow_step_share"] = float(cnt[slow].sum() / cnt.sum())
            return st, (lo, hi, counts, tabs, kw), r

        for tag, (w, chunk) in mats.items():
            x = xs[tag]
            st, (lo, hi, counts, tabs, kw), r = run_case(tag, w, chunk, x)
            if codec == "huffman":
                kw["prefix"] = ops.decode_matmul_prefix(st.books, dev)
            k_ms = cuda_ms(torch, lambda: kern(x, lo, hi, counts, *tabs,
                                               **kw), 10)
            lib = cuda_ms(torch, lambda: x @ w, 50)
            k_dev = device_ms(torch, lambda: kern(x, lo, hi, counts, *tabs,
                                                  **kw), 10)[0]
            lib_dev = device_ms(torch, lambda: x @ w, 50)[0]
            lo_bits = torch.from_numpy(st.entries["w"].planes["lo"]
                                       .bit_counts)
            hi_bits = torch.from_numpy(st.entries["w"].planes["hi"]
                                       .bit_counts)
            nb = lo.shape[0]
            nbytes = (x.numel() * 2 + 4 * (used_words(lo_bits)
                                           + used_words(hi_bits))
                      + nb * 4 + 2 * (3 * 17 + 256) * 4
                      + BATCH * w.shape[1] * 4)
            bound, by = least_ms(nbytes, 2 * 16 * w.numel(), int_ops_per_s,
                                 flops=2.0 * BATCH * w.numel())
            chain = chunk * step_ns * 1e-6
            groups = -(-nb // dm.GROUP)
            rec["ms"] += k_ms
            rec["plain_ms"] += r["plain_ms"]
            rec["bound_ms"] += bound
            rec["library_ms"] += lib
            rec["device_ms"] += k_dev
            rec["library_device_ms"] += lib_dev
            rec["chain_bound_ms"] += chain
            r.update(ms=k_ms, bound_ms=bound, bound_by=by,
                     chain_bound_ms=chain, library_ms=lib, device_ms=k_dev,
                     library_device_ms=lib_dev,
                     chain_steps=chunk, ns_per_step=k_ms * 1e6 / chunk,
                     ctas=groups, ctas_per_sm=ctas_per_sm,
                     waves=-(-groups // (ctas_per_sm * sms)),
                     coded_ratio=st.footprint()["ratio"])
            rec["by_matrix"][tag] = r
            del st, lo, hi, counts
        for tag, (w, chunk, x) in extra.items():
            x = x.to(torch.bfloat16).to(dev)
            st, _, r = run_case(tag, w, chunk, x)
            rec["extra_cases"][tag] = r
            del st
        slow = rec["extra_cases"]["slow path (2048 x 2048, geometric lo bytes)"]
        if codec == "huffman":
            need(slow["max_code_len"]["lo"] > PREFIX_BITS, "B7 slow-path "
                 f"case: the lo book's longest code is "
                 f"{slow['max_code_len']['lo']} bits, not over "
                 f"{PREFIX_BITS}")
        rec["bound_by"] = max(rec["by_matrix"].values(),
                              key=lambda r: r["bound_ms"])["bound_by"]
        out[kname] = rec
    return out


def step_without_sync(torch, params, cfg, prompts, spec) -> None:
    """Run one serve step (after a warm-up step that fills the per-book
    device tables) with torch's CUDA sync debug mode set to raise."""
    from repro_torch.models import prefill
    from repro_torch.serve import make_serve_step
    step = make_serve_step(cfg, spec)
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": prompts}, cfg,
                                 PROMPT + NEW)
        tok = logits[:, -1].argmax(-1)[:, None]
        logits, caches, _ = step(params, tok, caches, PROMPT)
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(params, tok, caches, PROMPT + 1)
        except RuntimeError as e:
            import traceback
            where = [ln for ln in traceback.format_exc().splitlines()
                     if "repro_torch" in ln or "chip_smoke" in ln]
            raise SmokeError(f"serve step ({spec.decode_backend}) waits for "
                             f"the device: {e}\n" + "\n".join(where)) from e
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def profile_steps(torch, params, cfg, prompts, spec, steps: int = 8):
    """Device time of ``steps`` serve steps after a prefill, from the
    profiler's kernel events: busy ms per step, the idle share of the
    steps' wall time, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import prefill
    from repro_torch.serve import make_serve_step
    step = make_serve_step(cfg, spec)
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": prompts}, cfg,
                                 PROMPT + NEW)
        tok = logits[:, -1].argmax(-1)[:, None]
        step(params, tok, caches, PROMPT)               # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            for i in range(1, steps + 1):
                logits, caches, _ = step(params, tok, caches, PROMPT + i)
                tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    kern = {}
    for e in p.key_averages():
        if e.device_type != DeviceType.CUDA:    # CPU ops repeat their
            continue                            # kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kern[e.key] = kern.get(e.key, 0.0) + us
    busy_ms = sum(kern.values()) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:12]
    # the port's own kernels (csrc/*.cu keep them in anonymous namespaces)
    port = {k.split("::")[1].split("(")[0]: v / 1e3 / steps
            for k, v in kern.items() if k.startswith("(anonymous namespace)")}
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels_ms_per_step": {k[:80]: v / 1e3 / steps
                                        for k, v in top},
            "port_kernels_ms_per_step": port}


def start_chain_probe(build):
    """Start nvcc on the chain probe, into the kernels' build directory."""
    out = build.build_dir() / "chain_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "chain_probe.cu"
    src.write_text(CHAIN_PROBE_CU)
    lib = out / "libchain_probe.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish_chain_probe(job):
    """Wait for the probe's nvcc and bind its C entry."""
    import ctypes
    proc, lib = job
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    need(proc.returncode == 0, f"nvcc failed on the chain probe:\n{out}")
    fn = ctypes.CDLL(str(lib)).chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chain_step_ns(torch, launch, dev, size: int = 1 << 13,
                  steps: int = 1 << 20) -> float:
    """ns per step of the chain probe: the least of three timed walks of
    ``steps`` dependent lookups through a ``size``-entry table whose
    entries form one random cycle; the walk's end is checked."""
    order = torch.randperm(size, generator=torch.Generator().manual_seed(SEED))
    table = torch.empty(size, dtype=torch.int64)
    table[order] = torch.roll(order, -1) << 3
    table = table.to(torch.int32).to(dev)
    sink = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        err = launch(table.data_ptr(), size, steps, sink.data_ptr(), stream)
        need(err == 0, f"chain probe: launch failed with cudaError_t {err}")

    best = min(cuda_ms(torch, run, 1) for _ in range(3))
    start = int((order == 0).nonzero()[0, 0])
    want = int(order[(start + steps + 1) % size]) << 3
    need(int(sink.item()) == want, "chain probe: the walk ended at "
         f"{int(sink.item())}, expected {want}")
    return best * 1e6 / steps


def multisym_windows(torch, lens, chunk: int, k: int, s_max: int):
    """Windows B4 steps through in each chunk of a plane whose codes have
    lengths ``lens`` (N,): from its cursor a window takes the following
    codes while they fit in k bits, at most s_max of them, and at least
    one (a longer code's slow path), as ``build_multisym_tables`` does."""
    dev = lens.device
    n = lens.numel()
    nb = -(-n // chunk)
    ln = torch.zeros(nb * chunk, dtype=torch.int64, device=dev)
    ln[:n] = lens.to(torch.int64)
    ends = torch.cat([torch.zeros((nb, 1), dtype=torch.int64, device=dev),
                      ln.reshape(nb, chunk).cumsum(1)], dim=1)
    counts = torch.clamp(n - torch.arange(nb, device=dev) * chunk, max=chunk)
    pos = torch.zeros(nb, dtype=torch.int64, device=dev)
    steps = torch.zeros(nb, dtype=torch.int64, device=dev)
    while True:
        live = pos < counts
        if not bool(live.any()):
            return steps
        reach = ends.gather(1, pos[:, None]) + k
        fit = torch.searchsorted(ends, reach, right=True)[:, 0] - 1
        nxt = torch.minimum(torch.maximum(fit, pos + 1), pos + s_max)
        pos = torch.where(live, nxt, pos)
        steps += live.to(torch.int64)


def kernel_bounds(torch, enc, chunk, cap_words, int_ops_per_s, step_ns):
    """Least time per call (one plane, the mean of the planes) for each
    kernel on this run's data: the larger of bytes over the HBM rate
    (each input read once, each output written once) and 32-bit
    operations over the card's INT32 rate.  B3 and B4 also get their
    chain bound: inside a chunk each step needs the step before it, so
    a call takes at least its longest chunk's steps (B3: its symbols,
    B4: its windows) times the least time of one step (``step_ns``)."""
    n = sum(e[0].numel() for e in enc.values()) / len(enc)
    bits = sum(int(e[3][1].to(torch.int64).sum()) for e in enc.values()
               ) / len(enc)
    nb = -(-int(n) // chunk)
    cap = cap_words(chunk)
    # words a decoder must read: each chunk's payload plus its pad word
    used_words = sum(int(((e[3][1].to(torch.int64) + 31) // 32 + 1).sum())
                     for e in enc.values()) / len(enc)
    tables = (3 * 17 + 256) * 4
    ms_tables = (1 << 13) * (8 + 2)

    def best(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / int_ops_per_s
        return (tb, "bytes") if tb >= to else (to, "operations")

    windows = bits / 13.0                   # a window consumes <= 13 bits
    out = {
        "encode_lookup": best(n + 256 * 8 + 8 * n + 8, 2 * n),
        "pack_blocks": best(8 * n + nb * cap * 4 + nb * 4, 12 * n),
        "decode_chunks_canonical": best(
            used_words * 4 + nb * 4 + tables + 2 * 4096 + nb * chunk * 4,
            8 * n + 5 * bits),
        "decode_chunks_multisym": best(
            used_words * 4 + nb * 4 + tables + ms_tables + nb * chunk * 4,
            12 * windows + 3 * n),
    }
    chain = {       # the longest chunk's steps, per plane
        "decode_chunks_canonical": {
            p: int(e[4].max()) for p, e in enc.items()},
        "decode_chunks_multisym": {
            p: int(multisym_windows(torch, e[2][1], chunk, e[6][0].shape[0]
                                    .bit_length() - 1, e[6][0].shape[1]).max())
            for p, e in enc.items()},
    }
    extra = {"mean_code_bits": bits / n, "symbols": int(n), "chunks": nb}
    res = {}
    for k, (t, by) in out.items():
        more = dict(extra)
        if k in chain:
            steps = sum(chain[k].values()) / len(enc)
            more.update(chain_steps_per_chunk=steps,
                        chain_steps_by_plane=chain[k], chain_step_ns=step_ns,
                        chain_bound_ms=steps * step_ns * 1e-6)
        res[k] = (t, by, more)
    return res


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
