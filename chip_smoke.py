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
   an odd-chunk case (chunk 1001, an e4m3 plane); each kernel is timed
   with CUDA events beside its plain version (and, for B1, the one-call
   gather ``lut[sym]`` as a yardstick the port never calls), and by the
   profiler's device events (``device_ms``: the device's own time a
   call, where the events loop also holds the host's), and B1's host
   time a call is read with ``time.perf_counter`` over calls that do not
   wait for the device (``host_us``); B1 and its yardstick, both
   host-bound, are read in turns and keep their least reading.  A chain
   probe (one thread, dependent shared-memory table lookups) measures
   the least time of one decode step, which bounds B3, B4 and B6-B8.
   The chunk walkers (B3, B4, B6; with B1 and B2 to code their input)
   also run on ``w_gate[0]``'s hi plane (33.5 M symbols, 16 384 chunks),
   B4 and B6 on a KV-shaped call (chunk 512, as many chunks as the coded
   serve's last read, 6840 a plane, held in phase 5 to the read that
   serve made) and B6 on the odd-chunk plane, each
   with its launch shape (chunks a CTA, warps, CTAs, CTAs an SM, waves),
   ns a step and chain bound.
   The same for B5-B8 ("kernels vs plain (B5-B8)"): B5 (histogram) on
   the logits planes, ``w_gate[0]``'s planes (33.5 M symbols), a plane
   of one value (2^25 symbols), views from bytes 1, 7 and 15 and lengths
   0, 1, 17 and 2^20 + 3, checked to be one device operation a call,
   timed on ``w_gate[0]`` in turns with the match probe (B5's other
   design: warp-aggregated shared atomics, a source kept here as a
   string) and as the store finds the plane (warm, right after the
   split) and after 128 MB of other traffic (cold), and on an empty
   plane (the cost of a call before it counts a symbol);
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
6. compressed collectives (``repro_torch.comm``) on a loopback ring of
   4 ranks stacked on one card, at ``gemma2-2b`` width: a data-parallel
   gradient all-reduce of one layer's ``w_gate`` shape (2048 x 16 384 bf16
   a rank, N(0, 1e-3^2), books from an earlier draw) by
   ``ring_all_reduce`` (carry ``wire`` and ``f32``, backends ``multisym``
   and ``scan``), ``ring_reduce_scatter``, the 2 x 2
   ``hierarchical_all_reduce`` and an integer-valued payload; the wire
   serve's step logits vocab-sharded over the ranks, gathered by
   ``ring_all_gather`` and the chunked and monolithic transports; a
   prefill hidden state (4 x 64 x 2048 a rank) through
   ``ring_all_to_all``; and ``launch.dryrun.ring_check`` at 8 ranks under
   both codecs.  Launch counts are reset before and read after these
   (``launches_by_path["ring"]``): B1, B2 and the hop decoder (B4, B3
   under ``scan``, B6 for QLC books) once a plane a hop, B5 for the
   payload probe.  Checked: the coded rings equal an uncoded loopback
   ring (the same hop schedule and adds) bit for bit, the integer payload
   ``torch.sum``, the gathers and the permute their inputs; every hop's
   ``hop_coded_bits`` equals B5's histogram . lengths of what it ships;
   ``raw_wire_bits`` the analytic 2(n-1)/n (all_reduce) or (n-1)/n
   (reduce_scatter) of the payload.  Each op is timed (CUDA events;
   profiler device time) with its coded/raw per hop, and a hop's parts
   (decode, add, recode, the loopback move) on their own; that hop's
   B1 -> B2 words and bits, for whole segments and for segments one
   symbol short, equal the plain versions' on CPU copies.  Every op also
   runs on CPU copies (the plain versions) at the logits size (1 024 000
   bf16 a rank; the all-to-all on the hidden state), with one e4m3
   all_reduce whose sums pass 448: the words of each hop, the stats and
   the results must be equal bit for bit, and the e4m3 sums hold NaNs.
   B3, B4 and B6 also walk a monolithic
   stream (one chunk of 1 024 000 symbols).  On one card a loopback hop
   moves no bytes over a link: the times are the codec's cost a hop;
7. train ``gemma2-2b`` at full width (depth not cut) through
   ``repro_torch.launch.train.train``: the seed-0 params, batch 4 x 128
   of ``SyntheticDataset`` tokens, AdamW lr 1e-3 with the cosine
   schedule, 8 steps with ``--compress`` semantics (books bootstrapped
   from the params, ``DriftThresholds(min_symbols=1024)``, a refresh
   check every 2 steps); launch counts reset before and read after these
   steps (``launches_by_path["train"]``: B5 on every gradient leaf and
   plane).  Checked: finite losses, ``grad_raw_bits`` = 16 x params, the
   bootstrap books go stale and an epoch flips, ``n_recompiles`` = the
   epochs built, B5 launched; then on one repeated batch (lr 1e-4) every
   leaf's B5 histograms equal the plain histogram of its bf16 planes, the
   probe's coded bits equal hist . lengths in int64, the refreshed books
   code the gradients at a lower coded/raw than the bootstrap books, and
   the loss falls over 4 steps (the 2nd and 3rd under the profiler:
   device ms a step, idle share, B5's ms; the 4th's host syncs counted);
   the step's parts (forward + backward, the probe, AdamW) are profiled
   on their own; the reduced config takes one step on the card and one
   on the CPU from the same params and batch, every reading of
   ``train.step.step_deviation`` within ``STEP_TOL``.  Printed: host-clock median step time and
   tokens/s, device ms and idle share, B5's share, coded/raw before and
   after the refresh, the refreshes' host seconds, peak memory;
8. lifecycle: ``launch.dryrun.drift_check`` at 8 ranks on the card
   (every field true), then the wire serve's setup (4 x 64 prompts, 16
   new tokens, ``multisym``) with ``Engine(lifecycle=,
   refresh_every=4)`` under thresholds 0 (every window stale): at least
   one refresh, every step lossless with B2 bits = B5 . the lengths of
   the epoch in force, the tokens of the same engine without
   ``lifecycle=`` (``launches_by_path["lifecycle"]``: B1, B2, B4, B5);
9. the last lines: one ``{"ring": ...}``, one ``{"lifecycle": ...}`` and
   one ``{"train": ...}`` record, one ``{"kernels": [...]}`` record
   (B1-B8), then ``{"ok": true, "device": {...}}``.

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
import math
import re
import subprocess
import sys
import time
import warnings
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

# B5's two other designs, timed beside it on the same planes (the caller
# zeroes ``out``; whole 512-byte tiles, 16-byte aligned, only).
#
# The match probe: warp-aggregated atomics.
# Each warp keeps its own 256 bins in shared memory; the lanes that hold
# the same symbol find each other (__match_any_sync) and one of them adds
# their number with one shared atomic.  Per-block bins go to the output
# with 64-bit atomics.  Every lane of a warp stays in the loop.
MATCH_PROBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
match_kernel(const uint4* __restrict__ vec, long long n_vec,
             unsigned long long* __restrict__ out) {
  __shared__ uint32_t s[8 * 256];
  for (int i = threadIdx.x; i < 8 * 256; i += 256) s[i] = 0u;
  __syncthreads();
  uint32_t* bins = s + (threadIdx.x >> 5) * 256;
  const int lane = threadIdx.x & 31;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n_vec;
       i += gridDim.x * 256ll) {
    const uint4 v = __ldg(vec + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const uint32_t b = (w[k >> 2] >> (8 * (k & 3))) & 0xFFu;
      const unsigned peers = __match_any_sync(0xffffffffu, b);
      if (lane == __ffs(peers) - 1) atomicAdd(&bins[b], __popc(peers));
    }
  }
  __syncthreads();
  uint32_t sum = 0;
  for (int w = 0; w < 8; ++w) sum += s[w * 256 + threadIdx.x];
  if (sum) atomicAdd(&out[threadIdx.x], static_cast<unsigned long long>(sum));
}

extern "C" int match_launch(const void* sym, long long n_vec, void* out,
                            int grid, void* stream) {
  match_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(sym), n_vec,
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


# The private probe: per-thread counters, no two lanes on one address.
# Each thread owns a column of 256 8-bit counters in shared memory (64 KB
# a block): bin b of thread t is byte b & 3 of the word at byte offset
# (b >> 2) * 1024 + 4t, one shared atomic add a symbol into the thread's
# own word; every 15 loads (240 symbols) a flush sums the columns into
# 32-bit bins, four threads a word in 16-bit lanes, and zeroes them.
PRIVATE_PROBE_CU = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void add(uint8_t* c, uint32_t off, uint32_t inc) {
  atomicAdd(reinterpret_cast<uint32_t*>(c + off), inc);
}

__device__ __forceinline__ void count4(uint8_t* c, uint32_t col,
                                       uint32_t col_hi, uint32_t v) {
  const uint32_t vb = (v & 0xFCFCFCFCu) | col_hi;
  const uint32_t vs = (v & 0x03030303u) << 3;
  add(c, __byte_perm(col, vb, 0x2240), __funnelshift_l(0u, 1u, vs));
  add(c, __byte_perm(col, vb, 0x2250), __funnelshift_l(0u, 1u, vs >> 8));
  add(c, __byte_perm(col, vb, 0x2260), __funnelshift_l(0u, 1u, vs >> 16));
  add(c, __byte_perm(col, vb, 0x2270), __funnelshift_l(0u, 1u, vs >> 24));
}

__device__ uint32_t flush(uint8_t* c, bool zero) {
  const int t = threadIdx.x, lane = t & 31;
  uint4* row = reinterpret_cast<uint4*>(c + (t >> 2) * 1024 + (t & 3) * 256);
  uint32_t lo = 0, hi = 0;
  for (int k = 0; k < 16; ++k) {
    const int j = (k + lane) & 15;
    const uint4 x = row[j];
    if (zero) row[j] = make_uint4(0u, 0u, 0u, 0u);
    lo += (x.x & 0x00FF00FFu) + (x.y & 0x00FF00FFu) + (x.z & 0x00FF00FFu) +
          (x.w & 0x00FF00FFu);
    hi += __byte_perm(x.x, 0, 0x4341) + __byte_perm(x.y, 0, 0x4341) +
          __byte_perm(x.z, 0, 0x4341) + __byte_perm(x.w, 0, 0x4341);
  }
  lo += __shfl_xor_sync(0xffffffffu, lo, 1);
  lo += __shfl_xor_sync(0xffffffffu, lo, 2);
  hi += __shfl_xor_sync(0xffffffffu, hi, 1);
  hi += __shfl_xor_sync(0xffffffffu, hi, 2);
  const uint32_t v = (t & 1) ? hi : lo;
  return (t & 2) ? v >> 16 : v & 0xFFFFu;
}

__global__ void __launch_bounds__(256, 3)
private_kernel(const uint4* __restrict__ vec, long long n_vec,
               unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t c[];
  const int t = threadIdx.x;
  const uint32_t col = 4u * t, col_hi = (t >> 6) * 0x01010101u;
  for (int w = 0; w < 64; ++w)
    *reinterpret_cast<uint32_t*>(c + w * 1024 + col) = 0u;
  const long long stride = gridDim.x * 256ll;
  const long long rounds = (n_vec + stride - 1) / stride;
  uint32_t total = 0;
  for (long long r = 0; r < rounds; ++r) {
    const long long i = blockIdx.x * 256ll + t + r * stride;
    if (i < n_vec) {
      const uint4 v = __ldg(vec + i);
      count4(c, col, col_hi, v.x);
      count4(c, col, col_hi, v.y);
      count4(c, col, col_hi, v.z);
      count4(c, col, col_hi, v.w);
    }
    if ((r + 1) % 15 == 0 && r + 1 < rounds) {
      __syncthreads();
      total += flush(c, true);
      __syncthreads();
    }
  }
  __syncthreads();
  total += flush(c, false);
  if (total) atomicAdd(&out[t], static_cast<unsigned long long>(total));
}

extern "C" int private_launch(const void* sym, long long n_vec, void* out,
                              int grid, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      private_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  if (e != cudaSuccess) return static_cast<int>(e);
  private_kernel<<<grid, 256, 65536, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(sym), n_vec,
      static_cast<unsigned long long*>(out));
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


def device_events(torch, fn, reps: int) -> dict:
    """name -> (device us, count) of every kernel, memset and copy that
    ``reps`` calls of ``fn`` (after one warm-up) ran, summed over the
    calls, from torch.profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            out[e.key] = (e.self_cuda_time_total if t is None else t,
                          e.count)
    return out


def device_ms(torch, fn, reps: int):
    """(device ms a call, device events a call) of ``fn``: the summed
    time of every device operation it runs.  Unlike ``cuda_ms``, no host
    time is in it."""
    ev = device_events(torch, fn, reps).values()
    return (sum(us for us, _ in ev) / 1e3 / reps,
            sum(n for _, n in ev) / reps)


def device_ops(torch, fn, reps: int = 20) -> dict:
    """name -> device operations a call of ``fn`` runs, over ``reps``
    calls."""
    return {k: n / reps
            for k, (_, n) in device_events(torch, fn, reps).items()}


def kernel_ms(torch, prep, fn, key: str, reps: int = 20) -> float:
    """Device ms a call of the kernels named like ``key`` that ``fn(x)``
    runs, x = ``prep()`` made anew on the same stream before each call
    (so ``prep`` sets what the call finds in the cache)."""
    ev = device_events(torch, lambda: fn(prep()), reps)
    return sum(us for k, (us, _) in ev.items() if key in k) / 1e3 / reps


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
    import ctypes
    jobs = [start_probe(build, "chain_probe", CHAIN_PROBE_CU),
            start_probe(build, "match_probe", MATCH_PROBE_CU),
            start_probe(build, "private_probe", PRIVATE_PROBE_CU)]
    try:
        libs = build.build_all()
    except BaseException:
        for _, proc, _ in jobs:
            proc.kill()
            proc.wait()
        raise
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    probe = finish_probe(jobs[0], "chain_launch",
                         [P, ctypes.c_int, LL, P, P])
    b5_probes = {name: finish_probe(job, f"{name}_launch",
                                    [P, LL, P, ctypes.c_int, P])
                 for name, job in (("match", jobs[1]), ("private", jobs[2]))}
    print(f"built {sorted(libs)} and the chain, match and private probes in "
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
    step_ns = chain_step_ns(torch, probe, dev)
    print(f"chain probe: {step_ns:.3f} ns per dependent lookup step [{card}]")
    walks = check_walkers(torch, dev, params, cfg, odd, int_ops_per_s,
                          step_ns, sms)
    for k, cases in walks.items():
        st = stats.setdefault(k, {"mismatches": 0, "max_abs_err": 0})
        for r in cases.values():
            st["mismatches"] += r["mismatches"]
            st["max_abs_err"] = max(st["max_abs_err"], r["max_abs_err"])
    for k, s in stats.items():
        need(s["mismatches"] == 0, f"kernel {k} disagrees with its plain "
             f"version: {s}")
    bounds = kernel_bounds(torch, main_enc, CHUNK, chunk_capacity_words,
                           int_ops_per_s, step_ns)
    nb_logits = main_enc["lo"][3][0].shape[0]
    logits_fields = {
        k: dict(ns_per_step=timing[k]["ms"] * 1e6
                / bounds[k][2]["chain_steps_per_chunk"],
                **launch_shape(k, nb_logits, sms))
        for k in ("decode_chunks_canonical", "decode_chunks_multisym")}
    for k, f in logits_fields.items():
        print_walk(k, "logits plane", dict(
            timing[k], **f, chain_bound_ms=bounds[k][2]["chain_bound_ms"]),
            card)
    for k, cases in walks.items():
        for tag, r in cases.items():
            print_walk(k, tag, r, card)
    t = timing["encode_lookup"]
    print(f"  encode_lookup: {t['ms']:.5f} ms a call (device "
          f"{t['device_ms']:.5f}, {t['device_events_per_call']:g} device "
          f"events a call, host {t['host_us']:.2f} us), lut[s.long()] "
          f"{t['library_ms']:.5f} ms (device {t['library_device_ms']:.5f}, "
          f"host {t['library_host_us']:.2f} us) [{card}]")

    phase("kernels vs plain (B5-B8)")
    t0 = time.perf_counter()
    new_kernels = check_b5_to_b8(torch, dev, params, step_logits,
                                 int_ops_per_s, step_ns, sms, b5_probes)
    for k, r in new_kernels.items():
        print(f"{k}: mismatches {r['mismatches']}, max abs err "
              f"{r['max_abs_err']}, {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}, plain {r['plain_ms']:.3f}, bound "
              f"{r['bound_ms']:.5f} by {r['bound_by']}) [{card}]")
        need(r["mismatches"] == 0, f"kernel {k} disagrees with its plain "
             f"version: {r['mismatches']} mismatching elements")
    r = new_kernels["histogram256"]
    print(f"  histogram256: {r['cases']} cases bit for bit; one call "
          f"{r['device_ops_per_call']} on the device; w_gate[0] hi "
          f"{r['w_gate0_hi_ms']:.4f} ms (device "
          f"{r['w_gate0_hi_device_ms']:.4f}; warm "
          f"{r['w_gate0_hi_warm_ms']:.4f}, cold "
          f"{r['w_gate0_hi_cold_ms']:.4f}), lo {r['w_gate0_lo_ms']:.4f}"
          f" ms (device {r['w_gate0_lo_device_ms']:.4f}), bound "
          f"{r['w_gate0_bound_ms']:.5f}; match probe hi "
          f"{r['w_gate0_hi_match_probe_ms']:.4f}, lo "
          f"{r['w_gate0_lo_match_probe_ms']:.4f} ms; private probe hi "
          f"{r['w_gate0_hi_private_probe_ms']:.4f}, lo "
          f"{r['w_gate0_lo_private_probe_ms']:.4f} ms; one value "
          f"{r['one_value_device_ms']:.4f}, empty plane "
          f"{r['empty_plane_device_ms']:.4f} ms (device); wave "
          f"{r.get('wave_ctas')} CTAs, CTAs on logits "
          f"{r.get('grid_logits')}, w_gate[0] {r.get('grid_w_gate0')} "
          f"[{card}]")
    b5_ops = r["device_ops_per_call"]
    need(sum(b5_ops.values()) == 1
         and not any("emset" in k for k in b5_ops),
         f"B5: one call ran {b5_ops} on the device, not one kernel")
    print_walk("decode_chunks_qlc", "logits plane",
               new_kernels["decode_chunks_qlc"], card)
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
    kv_case = {walks[k][f"kv call {p} plane"]["chunks"]
               for k in ("decode_chunks_multisym", "decode_chunks_qlc")
               for p in ("lo", "hi")}
    for codec in ("huffman", "qlc"):
        r = coded[codec]
        need(r["coded_steps"] == NEW - 1, f"{codec}: {r['coded_steps']} "
             f"coded decode steps")
        need(kv_case == {r["kv_last_read_chunks"]}, f"{codec}: the "
             f"KV-shaped calls of phase 3 ({kv_case} chunks) are not the "
             f"coded serve's last read ({r['kv_last_read_chunks']} chunks "
             f"a plane)")
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

    # ------------------------------ 6. compressed collectives (ring)
    phase("compressed collectives (loopback ring of 4 ranks)")
    ring, ring_launches = ring_phase(torch, dev, params, cfg, books,
                                     step_logits, warm, card, build)
    torch.cuda.empty_cache()

    # ------------------------------------ 7. train gemma2-2b (full width)
    phase("train gemma2-2b at full width (gradient probe, lifecycle)")
    del logits, planes
    trained, train_launches = train_phase(torch, dev, params, cfg, card,
                                          build)
    p = trained["profile"]
    print(f"train step: {trained['step_ms_median']:.1f} ms host-clock "
          f"median of {TRAIN_STEPS}, {trained['tokens_per_s']:.0f} tokens/s; "
          f"device {p['device_busy_ms_per_step']:.2f} ms a step, idle share "
          f"{p['idle_share']:.4f} (profiler, {p['steps']} steps), B5 "
          f"{trained['b5_device_ms_per_step']:.4f} ms a step "
          f"({100 * trained['b5_share_of_device']:.2f} % of device); "
          f"gradient coded/raw {trained['grad_coded_over_raw_bootstrap']:.4f}"
          f" (bootstrap books) -> "
          f"{trained['grad_coded_over_raw_refreshed']:.4f} (epoch "
          f"{trained['refreshed_epoch']}); refresh host s "
          f"{[round(r['seconds'], 4) for r in trained['refreshes']]}; "
          f"peak memory {trained['peak_memory_gb']:.2f} GB; host syncs "
          f"in a step {trained['host_syncs_a_step']} [{card}]")
    for k, r in trained["parts"].items():
        print(f"  train step part {k}: {r['wall_ms_per_step']:.2f} ms wall, "
              f"{r['device_busy_ms_per_step']:.2f} ms device, idle share "
              f"{r['idle_share']:.4f} (profiler, 2 calls) [{card}]")
    torch.cuda.empty_cache()

    # --------------------------------- 8. lifecycle: drift check, refresh
    phase("lifecycle (drift check, serve with book hot-refresh)")
    life, life_launches = lifecycle_phase(torch, dev, params, cfg, books,
                                          prompts, card, build)

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
    paths = {"wire_serve": launches, "coded_at_rest": coded_launches,
             "ring": ring_launches, "train": train_launches,
             "lifecycle": life_launches}
    kernels = []
    for k, (tag, src, replaces) in meta.items():
        t = dict(timing[k])
        bound_s, bound_by, extra = bounds[k]
        if k in logits_fields:          # the walkers' shapes and cases
            extra = dict(extra, **logits_fields[k], walks=walks[k])
        kernels.append({
            "name": f"{tag} {k}", "route": "cuda", "source": source + src,
            "replaces": replaces,
            "launches": sum(c[k] for c in paths.values()),
            "launches_by_path": {name: c[k] for name, c in paths.items()},
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
        if k in walks:
            r.update(mismatches=r["mismatches"] + stats[k]["mismatches"],
                     max_abs_err=max(r["max_abs_err"],
                                     stats[k]["max_abs_err"]),
                     walks=walks[k])
        kernels.append({
            "name": f"{tag} {k}", "route": "cuda", "source": source + src,
            "replaces": replaces,
            "launches": sum(c[k] for c in paths.values()),
            "launches_by_path": {name: c[k] for name, c in paths.items()},
            **r})
    print(json.dumps({"card": card, "serve": runs}))
    print(json.dumps({"ring": ring}))
    print(json.dumps({"card": card, "lifecycle": life}))
    print(json.dumps({"card": card, "train": trained}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def print_walk(kname: str, tag: str, r: dict, card: str) -> None:
    """One line of a decode kernel's case: time, step, launch shape."""
    print(f"  {kname} {tag}: {r['ms']:.4f} ms (device {r['device_ms']:.4f}),"
          f" {r['ns_per_step']:.2f} ns a step, {r['chunks_per_cta']} chunks "
          f"a CTA ({r['walker_warps_per_cta']} warps), {r['ctas']} CTAs, "
          f"{r['ctas_per_sm']} a SM, {r['waves']} wave(s), chain bound "
          f"{r['chain_bound_ms']:.4f} ms [{card}]")


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


SHAPE_ENTRIES = {"decode_chunks_canonical": "decode_canonical_shape",
                 "decode_chunks_multisym": "decode_multisym_shape",
                 "decode_chunks_qlc": "decode_qlc_shape"}


def launch_shape(kname: str, nb: int, sms: int) -> dict:
    """The launch of decode kernel ``kname`` (B3, B4 or B6) for ``nb``
    chunks, as its C entry chooses it: chunks (walker lanes) a CTA,
    walker warps a CTA, CTAs, dynamic shared memory a CTA, CTAs an SM
    holds at once, and waves."""
    import ctypes
    from repro_torch.kernels.build import I, P, bind
    shape = (ctypes.c_int * 5)()
    err = bind("decode", SHAPE_ENTRIES[kname], [I, P])(
        nb, ctypes.addressof(shape))
    need(err == 0, f"{kname} launch-shape query failed ({err})")
    per_cta, warps, ctas, smem, per_sm = list(shape)
    need(per_sm > 0, f"{kname}: no CTA fits an SM")
    return {"chunks_per_cta": per_cta, "walker_warps_per_cta": warps,
            "ctas": ctas, "smem_bytes_per_cta": smem, "ctas_per_sm": per_sm,
            "waves": -(-ctas // (per_sm * sms))}


def walk_case(torch, dev, kname, sym, book, chunk, int_ops_per_s, step_ns,
              sms) -> dict:
    """Decode kernel ``kname`` (B3, B4 or B6) on one symbol plane: coded
    by B1 + B2 with ``book``, decoded by the kernel and by its plain
    version, held bit for bit and to the plane, and timed (CUDA events,
    the profiler), with its launch shape, its chain (the longest chunk's
    steps: symbols for B3/B6, windows for B4) and its bounds on this
    data."""
    from repro_torch.core.encoder import PREFIX_BITS, chunk_counts_for
    from repro_torch.core.encoder import concat_chunks
    from repro_torch.core.huffman import MULTISYM_K, MULTISYM_SMAX
    from repro_torch.core.qlc import qlc_kernel_args
    from repro_torch.kernels import decode, ops
    words, bits = ops.encode_with_book(sym, book, chunk=chunk)
    cc = chunk_counts_for(sym.numel(), chunk)
    counts = torch.from_numpy(cc).to(dev)
    n, nb = sym.numel(), words.shape[0]
    nbits = int(bits.to(torch.int64).sum())
    stream_bytes = used_words(bits) * 4 + nb * 4 + nb * chunk * 4
    canonical_bytes = (3 * 17 + 256) * 4
    steps = int(counts.max())
    extra = {}
    if kname == "decode_chunks_qlc":
        args = qlc_kernel_args(book, dev)

        def run():
            return decode.decode_chunks_qlc(words, counts, *args, chunk=chunk)

        def plain():
            return decode.decode_chunks_qlc_plain(words, counts, *args,
                                                  chunk=chunk)
        bound, by = least_ms(stream_bytes + 256 * 4, 16 * n, int_ops_per_s)
        extra["qlc_class_lengths"] = book.class_lengths
    else:
        canon = book.device_tables("canonical", dev)
        lens = torch.from_numpy(book.lengths.astype("int64")).to(dev)[
            sym.long()]
        cut = PREFIX_BITS
        if kname == "decode_chunks_multisym":
            lut = book.device_tables("multisym", dev)

            def run():
                return decode.decode_chunks_multisym(words, counts, *lut,
                                                     *canon, chunk=chunk)

            def plain():
                return decode.decode_chunks_multisym_plain(
                    words, counts, *lut, *canon, chunk=chunk)
            win = multisym_windows(torch, lens, chunk, MULTISYM_K,
                                   MULTISYM_SMAX)
            steps, windows = int(win.max()), int(win.sum())
            bound, by = least_ms(stream_bytes + canonical_bytes
                                 + (1 << MULTISYM_K) * (MULTISYM_SMAX + 2),
                                 12 * windows + 3 * n, int_ops_per_s)
            extra["windows"] = windows
            cut = MULTISYM_K
        else:
            (pre,) = book.device_tables("prefix", dev)

            def run():
                return decode.decode_chunks_canonical(words, counts, *canon,
                                                      chunk=chunk, prefix=pre)

            def plain():
                return decode.decode_chunks_canonical_plain(
                    words, counts, *canon, chunk=chunk)
            bound, by = least_ms(stream_bytes + canonical_bytes
                                 + 2 * (1 << PREFIX_BITS),
                                 8 * n + 5 * nbits, int_ops_per_s)
        extra.update(max_code_len=int(book.lengths.max()),
                     slow_step_share=float((lens > cut).sum()) / n)
    got = run()
    want, plain_ms = timed_once(torch, plain)
    bad, err = compare(torch, (got,), (want,))
    need(torch.equal(concat_chunks(got, cc), sym), f"{kname}: the kernel "
         f"does not round-trip the plane")
    ms = cuda_ms(torch, run, 10)
    d_ms, _ = device_ms(torch, run, 10)
    return {"symbols": n, "chunks": nb, "chunk": chunk, "mismatches": bad,
            "max_abs_err": err, "ms": ms, "device_ms": d_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "chain_steps_per_chunk": steps, "chain_step_ns": step_ns,
            "chain_bound_ms": steps * step_ns * 1e-6,
            "ns_per_step": ms * 1e6 / steps, **extra,
            **launch_shape(kname, nb, sms)}


def kv_call_planes(torch, dev, params, cfg) -> dict:
    """The symbols of a KV-shaped decode call: the byte planes (lo, hi)
    of the K and V of the model's cache node over the PROMPT + NEW - 1
    positions that the coded serve's last read holds (a prefill of that
    many seeded tokens), one stream a plane: as many chunks of
    DEFAULT_KV_CHUNK as that read decodes a plane if its segments (the
    prompt's and one a decode step) are whole chunks.  Phase 5 holds the
    count to the read that the coded serve made (``kv_last_read_chunks``
    of its record)."""
    from repro_torch.core.symbols import bf16_planes
    from repro_torch.models import prefill
    slots = PROMPT + NEW - 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, slots), generator=gen,
                           device=dev)
    with torch.no_grad():
        _, caches = prefill(params, {"tokens": tokens}, cfg, PROMPT + NEW)
    (node,) = [n for group in caches for n in group]
    kv = [node[x][:, :, :slots] for x in ("k", "v")]
    return {p: torch.cat([bf16_planes(t)[p].reshape(-1) for t in kv])
            for p in ("lo", "hi")}


def check_walkers(torch, dev, params, cfg, odd, int_ops_per_s, step_ns,
                  sms) -> dict:
    """The chunk walkers beyond the logits planes, each against its plain
    version: B3, B4 and B6 on ``w_gate[0]``'s hi plane (33.5 M symbols,
    16 384 chunks at CHUNK, far more than SMs) with the plane's own
    Huffman book and a QLC book from the same counts; B4 and B6 on a
    KV-shaped call (chunk 512, the coded serve's last read); B6 on the
    odd-chunk e4m3 plane (chunk 1001), where B1-B4 ran.  Returns kernel ->
    case -> record."""
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.symbols import bf16_planes
    from repro_torch.kernels import histogram
    from repro_torch.memstore.kvstore import DEFAULT_KV_CHUNK
    t0 = time.perf_counter()
    out = {k: {} for k in SHAPE_ENTRIES}

    def books_of(sym):
        hist = histogram.histogram256(sym).cpu().numpy()
        return build_codebook(hist), build_codebook(hist, codec="qlc")

    def run(tag, sym, chunk, kernels):
        huff, qlc = books_of(sym)
        for k in kernels:
            book = qlc if k == "decode_chunks_qlc" else huff
            out[k][tag] = walk_case(torch, dev, k, sym, book, chunk,
                                    int_ops_per_s, step_ns, sms)

    gate_hi = bf16_planes(params["groups"][0][0]["ffn"]["w_gate"][0])["hi"]
    run("w_gate[0] hi plane", gate_hi, CHUNK, tuple(SHAPE_ENTRIES))
    for p, sym in kv_call_planes(torch, dev, params, cfg).items():
        run(f"kv call {p} plane", sym, DEFAULT_KV_CHUNK,
            ("decode_chunks_multisym", "decode_chunks_qlc"))
    for p, sym in odd.items():
        run(f"odd chunk {p} plane", sym, ODD_CHUNK, ("decode_chunks_qlc",))
    print(f"walkers beyond the logits planes: {time.perf_counter() - t0:.1f} s")
    return out


def check_b5_to_b8(torch, dev, params, step_logits, int_ops_per_s,
                   step_ns, sms, b5_probes):
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
    gate = bf16_planes(w_gate0)
    cases = {"logits lo": planes["lo"], "logits hi": planes["hi"],
             "w_gate[0] hi": gate["hi"], "w_gate[0] lo": gate["lo"],
             # the worst skew: every symbol in one bin of every counter
             "one value, 2^25 symbols": torch.full(
                 (1 << 25,), 0x3F, dtype=torch.uint8, device=dev)}
    for off in (1, 7, 15):              # views starting at any byte
        cases[f"logits lo from byte {off}"] = planes["lo"][off:]
    for n in (0, 1, 17, (1 << 20) + 3):  # ragged lengths
        cases[f"w_gate[0] lo[:{n}]"] = gate["lo"][:n]
    bad = err = 0
    for tag, sym in cases.items():
        got, want = histogram.histogram256(sym), histogram.histogram256_plain(
            sym)
        d = (got - want).abs()
        bad += int((d != 0).sum())
        err = max(err, int(d.max()))
        need(int(got.sum()) == sym.numel(), f"B5 {tag}: counts sum "
             f"{int(got.sum())} != {sym.numel()}")
    dev_ops = device_ops(torch, lambda: histogram.histogram256(gate["hi"]))
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
    bound, by = least_ms(n + 256 * 8, 2 * n, int_ops_per_s)
    gate_bound, _ = least_ms(gate["hi"].numel() + 256 * 8,
                             2 * gate["hi"].numel(), int_ops_per_s)
    rec = {"mismatches": bad, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "library_ms": lib_ms, "device_ms": dev_ms,
           "library_device_ms": lib_dev_ms, "symbols": n,
           "device_ops_per_call": dev_ops, "cases": len(cases),
           "w_gate0_symbols": gate["hi"].numel(),
           "w_gate0_bound_ms": gate_bound}
    # w_gate[0]'s planes (33.5 M symbols): B5 and its two probes in
    # turns, each plane's device time, and hi as the store finds it:
    # right after the split (warm) and after 128 MB of other traffic
    # (cold: more than the 50 MB L2).
    need(gate["hi"].numel() % 512 == 0, "B5 probes: whole 512-byte tiles")
    p_out = torch.zeros(256, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    probe_grid = {"match": 8 * sms, "private": 3 * sms}

    def probe(name, sym):
        e = b5_probes[name](sym.data_ptr(), sym.numel() // 16,
                            p_out.data_ptr(), probe_grid[name], stream)
        need(e == 0, f"{name} probe: launch failed with cudaError_t {e}")

    for p in ("hi", "lo"):
        for name in b5_probes:
            p_out.zero_()
            probe(name, gate[p])
            need(torch.equal(p_out, histogram.histogram256_plain(gate[p])),
                 f"{name} probe: wrong counts on w_gate[0] {p}")
        kern, *probe_ms = interleaved(
            (lambda: histogram.histogram256(gate[p]),
             *(lambda name=name: probe(name, gate[p]) for name in b5_probes)),
            lambda f: cuda_ms(torch, f, 20))
        rec[f"w_gate0_{p}_ms"] = kern
        for name, t in zip(b5_probes, probe_ms):
            rec[f"w_gate0_{p}_{name}_probe_ms"] = t
        rec[f"w_gate0_{p}_device_ms"] = device_ms(
            torch, lambda: histogram.histogram256(gate[p]), 20)[0]
    # the worst skew, and what a call costs before it counts a symbol
    rec["one_value_device_ms"] = device_ms(
        torch, lambda: histogram.histogram256(cases["one value, 2^25 "
                                                    "symbols"]), 20)[0]
    rec["empty_plane_device_ms"] = device_ms(
        torch, lambda: histogram.histogram256(gate["lo"][:0]), 50)[0]
    sink = torch.empty(1 << 25, dtype=torch.float32, device=dev)
    rec["w_gate0_hi_warm_ms"] = kernel_ms(
        torch, lambda: bf16_planes(w_gate0)["hi"], histogram.histogram256,
        "histogram256")
    rec["w_gate0_hi_cold_ms"] = kernel_ms(
        torch, lambda: (sink.add_(1.0), gate["hi"])[1],
        histogram.histogram256, "histogram256")
    if hasattr(histogram, "launch_grid"):   # an older B5 can be timed too
        wave = histogram.wave_ctas(dev.index)
        rec.update(wave_ctas=wave,
                   grid_logits=histogram.launch_grid(n, wave),
                   grid_w_gate0=histogram.launch_grid(gate["hi"].numel(),
                                                      wave))
    out["histogram256"] = rec

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
        "ns_per_step": ms * 1e6 / CHUNK, "symbols": n, "chunks": nb,
        "qlc_class_lengths": {p: b.class_lengths for p, b in books.items()},
        **launch_shape("decode_chunks_qlc", nb, sms)}

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
    """Device time of ``steps`` serve steps after a prefill and a warm-up
    step (``steps_profile``): busy ms per step, the idle share of the
    steps' wall time, the top kernels and the port's kernels."""
    from repro_torch.models import prefill
    from repro_torch.serve import make_serve_step
    step = make_serve_step(cfg, spec)
    with torch.no_grad():
        logits, caches = prefill(params, {"tokens": prompts}, cfg,
                                 PROMPT + NEW)
        tok = logits[:, -1].argmax(-1)[:, None]
        step(params, tok, caches, PROMPT)               # warm-up
        at = {"tok": tok, "pos": PROMPT}

        def one():
            at["pos"] += 1
            logits, _, _ = step(params, at["tok"], caches, at["pos"])
            at["tok"] = logits[:, -1].argmax(-1)[:, None]

        return steps_profile(torch, one, steps)[1]


def start_probe(build, name: str, source: str):
    """Start nvcc on a probe's source, into the kernels' build directory."""
    out = build.build_dir() / name
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"{name}.cu"
    src.write_text(source)
    lib = out / f"lib{name}.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, proc, lib


def finish_probe(job, entry: str, argtypes):
    """Wait for a probe's nvcc and bind its C entry ``entry``."""
    import ctypes
    name, proc, lib = job
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    need(proc.returncode == 0, f"nvcc failed on the {name}:\n{out}")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes = argtypes
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


# ------------------------------------------------------------ ring phase
RING_N = 4                    # ranks of the loopback ring (one card)
RING_CHUNK = 2048
E4M3_SIZE = 1 << 18           # symbols a rank of the e4m3 all_reduce case


def plain_ring(torch, x, carry: str, reduce_only: bool = False):
    """The uncoded loopback ring: the coded ring's hop schedule and adds
    with no coding.  x (n, size) bf16, n ranks stacked → (y, shipped):
    y (n, size) (``reduce_only``: (n, seg), rank i owning segment i), and
    for every hop the wire-dtype components each rank ships, (n, seg)
    apiece.  ``carry="f32"`` ships (rounded value, residual) pairs and
    adds in float32, as ``comm.ring`` does."""
    n, size = x.shape
    seg = -(-size // n)
    acc_dt = torch.float32 if carry == "f32" else x.dtype
    acc = torch.nn.functional.pad(x.to(acc_dt), (0, n * seg - size)
                                  ).reshape(n, n, seg)
    i = torch.arange(n, device=x.device)

    def comps(v):
        if carry == "wire":
            return (v,)
        hi = v.to(x.dtype)
        return (hi, (v - hi.float()).to(x.dtype))

    def value(c):
        return c[0] if carry == "wire" else c[0].float() + c[1].float()

    def hop(c):
        return tuple(torch.roll(ci, 1, 0) for ci in c)

    shipped = []
    start = -1 if reduce_only else 0
    cur = acc[i, (i + start) % n]
    for t in range(n - 1):
        c = comps(cur)
        shipped.append(c)
        cur = value(hop(c)) + acc[i, (i + start - t - 1) % n]
    if reduce_only:
        return cur.to(x.dtype), shipped
    out = torch.zeros((n, n, seg), dtype=acc_dt, device=x.device)
    out[i, (i + 1) % n] = cur
    c = comps(cur)
    for t in range(n - 1):
        shipped.append(c)
        c = hop(c)
        out[i, (i - t) % n] = value(c)
    return out.reshape(n, -1)[:, :size].to(x.dtype), shipped


def plain_hierarchy(torch, x):
    """The uncoded 2 x 2 hierarchical all_reduce (wire carry): x (n_o,
    n_i, size) → inner reduce-scatter, outer all-reduce on the owned
    segment, inner all-gather."""
    n_o, n_i, size = x.shape
    seg = torch.stack([plain_ring(torch, x[o], "wire", True)[0]
                       for o in range(n_o)])                 # (o, i, seg)
    red = torch.stack([plain_ring(torch, seg[:, i], "wire")[0]
                       for i in range(n_i)], dim=1)         # (o, i, seg)
    full = red.reshape(n_o, 1, -1)[..., :size]
    return full.expand(n_o, n_i, size)


def recording_axes(torch, LoopbackAxis, sizes):
    """Loopback axes (``loopback_mesh``'s layout) that keep every tensor
    they move: the words (and bit counts) of each hop or gather."""
    sent = []

    class Rec(LoopbackAxis):
        def ppermute(self, tensors, shift):
            sent.extend(tensors if isinstance(tensors, tuple) else
                        (tensors,))
            return super().ppermute(tensors, shift)

        def all_gather(self, t):
            sent.append(t)
            return super().all_gather(t)

    batch = tuple(sizes.values())
    axes = {name: Rec(n, name=name, batch=batch, dim=d)
            for d, (name, n) in enumerate(sizes.items())}
    return axes, sent


def bits_of(torch, t):
    """A tensor's bit pattern as an integer tensor (for bitwise equality)."""
    ints = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
            torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def ring_phase(torch, dev, params, cfg, books, step_logits, warm, card,
               build):
    """The compressed collectives on a loopback ring of RING_N ranks at
    gemma2-2b width (see the module docstring, phase 6).  Returns the
    ring record and the main path's launch counts."""
    from repro_torch.comm import (TRANSPORTS, LoopbackAxis,
                                  hierarchical_all_reduce, loopback_mesh,
                                  ring_all_gather, ring_all_reduce,
                                  ring_all_to_all, ring_reduce_scatter)
    from repro_torch.core.codebook import build_codebook
    from repro_torch.core.encoder import decode_jit, encode_jit
    from repro_torch.core.symbols import SCHEMES
    from repro_torch.kernels.ops import message_bits, recode_with_book
    from repro_torch.launch.dryrun import ring_check
    from repro_torch.models.blocks import block_apply
    from repro_torch.models.layers import embed_apply
    from repro_torch.models.transformer import _layers
    from repro_torch.comm.transport import decode_blocks
    from repro_torch.comm.wire import wire_add

    n = RING_N
    ax = LoopbackAxis(n)
    mesh = loopback_mesh({"outer": 2, "inner": 2})
    hier_axes = (mesh["inner"], mesh["outer"])
    t_phase = time.perf_counter()

    def hist_books(t, codec="huffman"):
        return {p: build_codebook(histogram_np(torch, s), codec=codec)
                for p, s in SCHEMES["bf16"].to_symbols(t).items()}

    # DP gradient all-reduce: every rank holds one layer's w_gate-shaped
    # gradient, N(0, 1e-3^2); books from an earlier draw (another seed).
    shape = (cfg.d_model, cfg.d_ff)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    grad_books = hist_books(torch.randn(shape, generator=g, device=dev)
                            * 1e-3)
    g.manual_seed(SEED + 2)
    grads = (torch.randn((n, *shape), generator=g, device=dev)
             * 1e-3).to(torch.bfloat16)
    ints = torch.randint(-2, 3, (n, *shape), generator=g,
                         device=dev).to(torch.bfloat16)
    int_books = hist_books(torch.randint(-2, 3, shape, generator=g,
                                         device=dev).to(torch.bfloat16))
    # TP logits gather: the wire serve's step logits, vocab-sharded.
    shards = step_logits.reshape(BATCH, n, -1).transpose(0, 1).contiguous()
    # A prefill hidden state split four ways: rank r holds the hidden
    # state after block r of the warm-up prefill (4 x 64 x 2048).
    with torch.no_grad():
        h = embed_apply(params["embed"], warm, cfg)
        hid = []
        for _, _, _, kind, p in _layers(cfg, params):
            h = block_apply(kind, p, h, cfg)
            hid.append(h.to(torch.bfloat16))
            if len(hid) == n:
                break
    hidden = torch.stack(hid)                      # (rank, 4, 64, 2048)
    hid_books = hist_books(hid[0])
    who = {
        "dp_grad": f"data-parallel gradient sync: {n} replicas all-reduce "
                   f"one layer's w_gate gradient {tuple(shape)} bf16",
        "tp_logits": f"tensor-parallel serving: {n} vocab shards of a "
                     f"batch-{BATCH} step's logits gathered on every rank",
        "prefill_a2a": f"sequence/expert parallelism: a prefill hidden "
                       f"state {tuple(hidden.shape[1:])} redistributed "
                       f"among {n} ranks",
    }
    for k, v in who.items():
        print(f"  {k}: {v}")

    def ar(carry, backend, x=None):
        return lambda a=ax: ring_all_reduce(
            grads if x is None else x, a,
            grad_books if x is None else int_books, chunk=RING_CHUNK,
            decode_backend=backend, carry=carry)

    ops = {
        "ar_wire_multisym": ("ar", 1, ar("wire", "multisym")),
        "ar_f32_multisym": ("ar", 2, ar("f32", "multisym")),
        "ar_wire_scan": ("ar", 1, ar("wire", "scan")),
        "ar_f32_scan": ("ar", 2, ar("f32", "scan")),
        "rs_wire_multisym": ("rs", 1, lambda a=ax: ring_reduce_scatter(
            grads, a, grad_books, chunk=RING_CHUNK)),
        "hier_2x2": ("hier", 1, lambda a=hier_axes: hierarchical_all_reduce(
            grads.reshape(2, 2, *shape), a, grad_books, chunk=RING_CHUNK)),
        "ar_int": ("ar", 1, ar("wire", "multisym", ints)),
        "ring_ag": ("ag", 1, lambda a=ax: ring_all_gather(
            shards, a, books, chunk=RING_CHUNK)),
        "chunked_ag": ("chunked", 1, lambda a=ax: TRANSPORTS[
            "chunked"].all_gather(shards, a, books, chunk=RING_CHUNK)),
        "mono_ag": ("mono", 1, lambda a=ax: TRANSPORTS[
            "monolithic"].all_gather(shards, a, books)),
        "ring_a2a": ("a2a", 1, lambda a=ax: ring_all_to_all(
            hidden, a, hid_books, chunk=RING_CHUNK)),
    }

    # ---- the main path: launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    results, per_op = {}, {}
    for name, (_, _, fn) in ops.items():
        before = dict(build.LAUNCHES)
        results[name] = fn()
        per_op[name] = {k: build.LAUNCHES[k] - before[k]
                        for k in build.LAUNCHES
                        if build.LAUNCHES[k] != before[k]}
    checks = {codec: ring_check(8, codec=codec, device=dev, verbose=False)
              for codec in ("huffman", "qlc")}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"ring main path: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches} [{card}]")

    # ---- results against the uncoded ring, sums, gathers, permutes
    for codec, rec in checks.items():
        need(rec["status"] == "ok", f"ring_check ({codec}) on the card: "
             f"{rec}")
    for name in ("ar_wire_multisym", "ar_f32_multisym", "ar_wire_scan",
                 "ar_f32_scan", "rs_wire_multisym"):
        carry = "f32" if "f32" in name else "wire"
        y, st = results[name]
        flat = grads.reshape(n, -1)
        want, shipped = plain_ring(torch, flat, carry,
                                   reduce_only=name.startswith("rs"))
        need(torch.equal(bits_of(torch, y.reshape(want.shape)),
                         bits_of(torch, want)),
             f"{name}: coded ring != uncoded loopback ring")
        hop = st["hop_coded_bits"][0].tolist()
        need(len(hop) == len(shipped), f"{name}: {len(hop)} hops")
        for h, c in enumerate(shipped):            # B5 . lengths per hop
            bits = sum(int(message_bits(p_sym, grad_books[p].lengths))
                       for ci in c for p, p_sym in
                       SCHEMES["bf16"].to_symbols(ci).items())
            need(bits / n == hop[h], f"{name} hop {h}: hop_coded_bits "
                 f"{hop[h]} != B5 . lengths {bits / n}")
        ncomp = 2 if carry == "f32" else 1
        f = 2.0 * (n - 1) / n if name.startswith("ar") else (n - 1) / n
        need(float(st["raw_wire_bits"][0]) == f * flat.shape[1] * 16 * ncomp,
             f"{name}: raw_wire_bits {float(st['raw_wire_bits'][0])}")
    y, _ = results["hier_2x2"]
    need(torch.equal(bits_of(torch, y.reshape(2, 2, -1)), bits_of(
        torch, plain_hierarchy(torch, grads.reshape(2, 2, -1)))),
         "hier_2x2: coded != uncoded hierarchical ring")
    y, _ = results["ar_int"]
    need(torch.equal(y.float(), ints.float().sum(0).expand_as(y)),
         "ar_int: integer payload != torch.sum")
    gathered = shards.reshape(1, -1, shards.shape[-1]).expand(n, -1, -1)
    for name in ("ring_ag", "chunked_ag", "mono_ag"):
        need(torch.equal(bits_of(torch, results[name][0]),
                         bits_of(torch, gathered)), f"{name}: gather")
    coded = {k: float(results[k][1]["coded_wire_bits"][0])
             for k in ("ring_ag", "chunked_ag", "mono_ag")}
    need(len(set(coded.values())) == 1, f"all_gather coded bits {coded}")
    need(torch.equal(bits_of(torch, results["ring_a2a"][0]),
                     bits_of(torch, hidden.transpose(0, 1))),
         "ring_a2a: != the permuted shards")

    # ---- one launch a plane a hop (B4, or B3 under scan; B1 = B2).  A
    # coded stream is made for every hop that ships one and for no other
    # (all_reduce: its 2(n-1) hops; reduce-scatter, all_gather and
    # all_to_all: n-1); the 2 x 2 hierarchy: 1 + 2 + 1.
    encodes = {"ar": 2 * n - 2, "rs": n - 1, "hier": 4, "ag": n - 1,
               "a2a": n - 1}
    decoder = {"scan": "decode_chunks_canonical"}
    for name, (kind, ncomp, _) in ops.items():
        grew = per_op[name]
        if kind in encodes:
            hops = round(float(results[name][1]["hops"].sum()))
            dk = decoder.get(name.split("_")[-1], "decode_chunks_multisym")
            need(grew.get(dk, 0) == hops * 2 * ncomp,
                 f"{name}: {grew.get(dk, 0)} {dk} launches for {hops} hops")
            for k in ("encode_lookup", "pack_blocks"):
                need(grew.get(k, 0) == encodes[kind] * 2 * ncomp,
                     f"{name}: {grew.get(k, 0)} {k} launches")
        if kind in ("ar", "rs", "hier", "a2a"):
            need(grew.get("histogram256", 0) > 0, f"{name}: B5 not launched")
    for k in ("encode_lookup", "pack_blocks", "decode_chunks_multisym",
              "decode_chunks_canonical", "histogram256",
              "decode_chunks_qlc"):
        need(launches[k] > 0, f"ring: kernel {k} was not launched")

    # ---- time a call of each op (events; profiler device time)
    rec = {"n_ranks": n, "chunk": RING_CHUNK, "card": card, "who": who,
           "ops": {}, "hops": {}}
    for name, (kind, ncomp, fn) in ops.items():
        y, st = results[name]
        hop = (st["hop_coded_bits"].reshape(
            -1, st["hop_coded_bits"].shape[-1])[0].tolist()
            if "hop_coded_bits" in st else [])
        r = {"ms": cuda_ms(torch, fn, 2), "launches": per_op[name],
             "raw_wire_bits": float(st["raw_wire_bits"].reshape(-1)[0]),
             "coded_wire_bits": float(st["coded_wire_bits"].reshape(-1)[0])}
        r["device_ms"], r["device_ops"] = device_ms(torch, fn, 2)
        r["coded_over_raw"] = r["coded_wire_bits"] / r["raw_wire_bits"]
        if hop:
            seg_bits = r["raw_wire_bits"] / len(hop)
            r["hop_coded_over_raw"] = [b / seg_bits for b in hop]
        rec["ops"][name] = r
        print(f"  {name}: {r['ms']:.3f} ms (device {r['device_ms']:.3f} ms, "
              f"{r['device_ops']:.0f} device ops), coded/raw "
              f"{r['coded_over_raw']:.4f}"
              + (", per hop " + " ".join(f"{v:.4f}" for v in
                                          r["hop_coded_over_raw"])
                 if hop else "") + f" [{card}]")

    # ---- one hop's parts at the w_gate size (a reduce-scatter hop)
    seg = grads.reshape(n, -1)[:, :grads[0].numel() // n].contiguous()
    seg_len = seg.shape[1]
    counts = torch.full((n * seg_len // RING_CHUNK,), RING_CHUNK,
                        dtype=torch.int32, device=dev)
    planes = {p: s.reshape(-1, RING_CHUNK)
              for p, s in SCHEMES["bf16"].to_symbols(seg).items()}
    enc = {p: recode_with_book(b, seg_len, grad_books[p])
           for p, b in planes.items()}
    # B1 -> B2 on that hop (whole chunks, as the main path's) and on the
    # same blocks read as segments one symbol short (a ragged tail in
    # every rank's last chunk), held to the plain versions on CPU copies
    t0 = time.perf_counter()
    for n_seg in (seg_len, seg_len - 1):
        for p, b in planes.items():
            got = (enc[p] if n_seg == seg_len else
                   recode_with_book(b, n_seg, grad_books[p]))
            want = recode_with_book(b.cpu(), n_seg, grad_books[p])
            need(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
                 f"w_gate hop recode ({p} plane, {n_seg} symbols a "
                 f"segment): the card's words or bits != the plain "
                 f"versions'")
    print(f"w_gate hop recode (B1 -> B2, {n} x {seg_len} symbols a plane, "
          f"whole and ragged segments): words and bits equal to the plain "
          f"versions ({time.perf_counter() - t0:.1f} s)")
    parts = {
        "decode_multisym": lambda: [decode_blocks(
            w, counts, grad_books[p], RING_CHUNK, "multisym")
            for p, (w, _) in enc.items()],
        "decode_scan": lambda: [decode_blocks(
            w, counts, grad_books[p], RING_CHUNK, "scan")
            for p, (w, _) in enc.items()],
        "add": lambda: wire_add(seg, seg),
        "recode": lambda: [recode_with_book(
            s.reshape(-1, RING_CHUNK), seg_len, grad_books[p])
            for p, s in SCHEMES["bf16"].to_symbols(seg).items()],
        "recode_ragged": lambda: [recode_with_book(
            s.reshape(-1, RING_CHUNK), seg_len - 1, grad_books[p])
            for p, s in SCHEMES["bf16"].to_symbols(seg).items()],
        "roll": lambda: [ax.ppermute(w.view(n, -1, w.shape[-1]), 1)
                         for w, _ in enc.values()],
    }
    for k, fn in parts.items():
        r = {"ms": cuda_ms(torch, fn, 10)}
        r["device_ms"], r["device_ops"] = device_ms(torch, fn, 10)
        rec["hops"][k] = r
        print(f"  hop part {k} ({n} ranks x {seg.shape[1]} elements, both "
              f"planes): {r['ms']:.4f} ms (device {r['device_ms']:.4f}) "
              f"[{card}]")

    # ---- kernels against plain at the logits size, bit for bit
    t0 = time.perf_counter()
    small = grads.reshape(n, -1)[:, :BATCH * cfg.vocab_size].contiguous()
    cases = {
        "ar_wire_multisym": lambda x, a: ring_all_reduce(
            x, a["r"], grad_books, chunk=RING_CHUNK),
        "ar_f32_multisym": lambda x, a: ring_all_reduce(
            x, a["r"], grad_books, chunk=RING_CHUNK, carry="f32"),
        "ar_wire_scan": lambda x, a: ring_all_reduce(
            x, a["r"], grad_books, chunk=RING_CHUNK, decode_backend="scan"),
        "rs_wire_multisym": lambda x, a: ring_reduce_scatter(
            x, a["r"], grad_books, chunk=RING_CHUNK),
        "hier_2x2": lambda x, a: hierarchical_all_reduce(
            x.reshape(2, 2, -1), (a["inner"], a["outer"]), grad_books,
            chunk=RING_CHUNK),
        "ring_ag": lambda x, a: ring_all_gather(x, a["r"], books,
                                                chunk=RING_CHUNK),
        "chunked_ag": lambda x, a: TRANSPORTS["chunked"].all_gather(
            x, a["r"], books, chunk=RING_CHUNK),
        "mono_ag": lambda x, a: TRANSPORTS["monolithic"].all_gather(
            x, a["r"], books),
        "ring_a2a": lambda x, a: ring_all_to_all(x, a["r"], hid_books,
                                                 chunk=RING_CHUNK),
        "ar_e4m3_wire": lambda x, a: ring_all_reduce(
            x, a["r"], e4m3_books, "e4m3", chunk=RING_CHUNK),
    }
    # e4m3 payloads whose ring sums pass 448 (XLA's overflow to NaN)
    g.manual_seed(SEED + 3)
    e4m3 = (torch.randn((n, E4M3_SIZE), generator=g, device=dev)
            * 150).to(torch.float8_e4m3fn)
    e4m3_books = {p: build_codebook(histogram_np(torch, s), codec="huffman")
                  for p, s in SCHEMES["e4m3"].to_symbols(e4m3).items()}
    inputs = {"ring_ag": shards, "chunked_ag": shards, "mono_ag": shards,
              "ring_a2a": hidden, "ar_e4m3_wire": e4m3}
    compared = {}
    for name, fn in cases.items():
        x = inputs.get(name, small)
        sizes = ({"outer": 2, "inner": 2} if name.startswith("hier")
                 else {"r": n})
        out = []
        for d in (dev, torch.device("cpu")):
            axes, sent = recording_axes(torch, LoopbackAxis, sizes)
            y, st = fn(x.to(d), axes)
            out.append((y, st, sent))
        (gy, gst, gsent), (cy, cst, csent) = out
        need(len(gsent) == len(csent) and all(
            torch.equal(a.cpu(), b) for a, b in zip(gsent, csent)),
             f"{name}: the card's hop words differ from the plain versions'")
        need(set(gst) == set(cst) and all(
            torch.equal(gst[k].cpu(), cst[k]) for k in gst),
             f"{name}: stats differ from the plain versions'")
        need(torch.equal(bits_of(torch, gy.cpu()), bits_of(torch, cy)),
             f"{name}: result differs from the plain versions'")
        compared[name] = {"tensors_moved": len(gsent),
                          "symbols_a_rank": x[0].numel()}
        if gy.dtype == torch.float8_e4m3fn:
            nans = int(torch.isnan(gy.float()).sum())
            need(nans > 0, f"{name}: no sum passed 448 (no NaN)")
            compared[name]["nan_results"] = nans
    rec["kernels_vs_plain"] = compared
    print(f"kernels vs plain at the logits size: {len(compared)} ops, every "
          f"hop's words, stats and results equal ("
          f"{time.perf_counter() - t0:.1f} s)")

    # ---- B3, B4, B6 walk a monolithic stream: chunk = 1 024 000
    mono = {}
    for p, sym in SCHEMES["bf16"].to_symbols(step_logits).items():
        for codec in ("huffman", "qlc"):
            b = build_codebook(histogram_np(torch, sym), codec=codec)
            w, _ = encode_jit(sym, b.codes, b.lengths)
            t = b.tables if codec == "huffman" else None
            fns = ({"B4 multisym": lambda: b_decode(b, w, sym),
                    "B3 canonical": lambda: decode_jit(
                        w, t.first_code, t.base_index, t.num_codes,
                        t.sorted_symbols, sym.numel())}
                   if codec == "huffman" else
                   {"B6 qlc": lambda: b_decode(b, w, sym)})
            for k, fn in fns.items():
                got, ms = timed_once(torch, fn)
                if p == "hi":
                    plain = (b_decode(b, w.cpu(), sym) if "B3" not in k else
                             decode_jit(w.cpu(), t.first_code, t.base_index,
                                        t.num_codes, t.sorted_symbols,
                                        sym.numel()))
                    need(torch.equal(got.cpu().to(torch.uint8),
                                     plain.to(torch.uint8)),
                         f"monolithic {k}: kernel != plain")
                need(torch.equal(got.to(torch.uint8), sym),
                     f"monolithic {k}: does not round-trip the {p} plane")
                mono[f"{k} {p}"] = ms
    rec["monolithic_decode_ms"] = mono
    print("monolithic decode, one chunk of 1 024 000 symbols: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in mono.items()) + f" [{card}]")
    rec["seconds"] = time.perf_counter() - t_phase
    return rec, launches


# ------------------------------------------------------ train phase
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_EXTRA = 4, 128, 8, 4
TRAIN_LR, TRAIN_REFRESH = 1e-3, 2


def steps_profile(torch, fn, steps: int):
    """Device time of ``steps`` calls of ``fn`` (each one step, ending in
    the step's own host sync) under torch.profiler: busy ms a step from
    the device events, the idle share of the steps' wall time, the
    port's kernels' ms a step and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        out = [fn() for _ in range(steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = {}
    for e in p.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kern[e.key] = kern.get(e.key, 0.0) + us
    busy_ms = sum(kern.values()) / 1e3 / steps
    wall_ms = wall * 1e3 / steps
    short = {}
    for k, v in kern.items():                   # names cut to 80 chars
        short[k[:80]] = short.get(k[:80], 0.0) + v / 1e3 / steps
    port = {k.split("::")[1].split("(")[0]: v / 1e3 / steps
            for k, v in kern.items() if k.startswith("(anonymous namespace)")}
    return out, {"steps": steps, "wall_ms_per_step": wall_ms,
                 "device_busy_ms_per_step": busy_ms,
                 "idle_share": 1.0 - busy_ms / wall_ms,
                 "port_kernels_ms_per_step": port,
                 "top_kernels_ms_per_step": dict(sorted(
                     short.items(), key=lambda kv: -kv[1])[:10])}


def train_phase(torch, dev, params, cfg, card, build):
    """Phase 7: gemma2-2b trained at full width on the card through
    ``launch.train.train`` (see the module docstring).  Returns the
    record and the main path's launch counts."""
    from repro_torch.core.symbols import bf16_planes
    from repro_torch.data import DataConfig, SyntheticDataset
    from repro_torch.kernels.histogram import histogram256_plain
    from repro_torch.launch.train import train
    from repro_torch.models import model_init, param_count
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train.step import (STEP_TOL, grad_payload_stats,
                                        loss_and_grads, make_train_step,
                                        step_deviation, train_state_init)
    from repro_torch.comm.compression import histogram256

    t_phase = time.perf_counter()
    n_params = param_count(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    run = train(cfg, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                seq_len=TRAIN_SEQ, lr=TRAIN_LR, compress=True,
                refresh_every=TRAIN_REFRESH, seed=SEED, device=dev,
                params=params)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    mgr, steps, refreshes = run["lifecycle"], run["steps"], run["refreshes"]
    print(f"train main path: {run['seconds']:.1f} s, launches {launches} "
          f"[{card}]")

    need(all(math.isfinite(s["loss"]) for s in steps),
         f"train: a loss is not finite: {[s['loss'] for s in steps]}")
    need(all(s["grad_raw_bits"] == 16.0 * n_params for s in steps),
         f"train: grad_raw_bits != 16 x {n_params} params")
    epochs = [s["book_epoch"] for s in steps]
    need(epochs[0] == 2.0 and refreshes and max(epochs) > 2.0,
         f"train: the bootstrap books never went stale (epochs {epochs}, "
         f"refreshes {refreshes})")
    built = set(epochs) | {float(mgr.book_epoch)}
    need(mgr.n_recompiles == len(built), f"train: {mgr.n_recompiles} step "
         f"builds for the epochs {sorted(built)}")
    need(launches["histogram256"] > 0, "train: kernel B5 was not launched")

    # ---- the repeated batch: 4 extra steps at a constant lr, the 2nd
    # and 3rd under the profiler, the host syncs of the 4th counted; the
    # loss must fall.  The lr is a tenth of the run's peak: a constant
    # 1e-3 overshoots on one batch at this width (7.75, 11.76, 11.94,
    # 10.22 in a first run on the card)
    state = run["state"]
    spec_new = mgr.spec("grad", "bf16")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(SyntheticDataset(
        cfg, DataConfig(TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 1))).items()}
    _, _, grads = loss_and_grads(state.params, batch, cfg)

    # ---- every leaf's B5 histograms against the plain histogram, and
    # the probe's coded bits against hist . lengths in int64
    total = {p: torch.zeros(256, dtype=torch.int64, device=dev)
             for p in ("lo", "hi")}
    for leaf in tree_leaves(grads):
        for p, sym in bf16_planes(leaf).items():
            h = histogram256(sym)
            need(torch.equal(h, histogram256_plain(sym)),
                 f"train: B5 != plain on a {tuple(leaf.shape)} gradient "
                 f"leaf's {p} plane")
            total[p] += h
    coded = sum(int((total[p] * torch.from_numpy(spec_new.lengths_for(p))
                     .to(dev, torch.int64)).sum()) for p in total)
    probe_new = grad_payload_stats(grads, spec_new)
    probe_boot = grad_payload_stats(grads, run["spec"])
    need(all(torch.equal(probe_new[f"hist_{p}"], total[p]) for p in total)
         and float(probe_new["coded_bits"]) == float(coded),
         f"train: grad_coded_bits {float(probe_new['coded_bits'])} != "
         f"hist . lengths {coded}")
    raw = float(probe_new["raw_bits"])
    ratio_boot = float(probe_boot["coded_bits"]) / raw
    ratio_new = float(probe_new["coded_bits"]) / raw
    need(ratio_new < ratio_boot, f"train: the refreshed books (epoch "
         f"{mgr.book_epoch}) code the gradients at {ratio_new} of raw, "
         f"the bootstrap books at {ratio_boot}")
    del grads, probe_new, probe_boot

    extra = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR / 10),
                            comp_spec=spec_new)
    box = {"state": state}

    def one():
        box["state"], m = extra(box["state"], batch)
        return float(m["loss"])

    losses = [one()]
    more, prof = steps_profile(torch, one, TRAIN_EXTRA - 2)
    losses += more
    torch.cuda.synchronize()        # the last: its host syncs counted
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            box["state"], m = extra(box["state"], batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    step_syncs = sum("synchronizing" in str(w.message) for w in caught)
    losses.append(float(m["loss"]))
    # the step's parts on the last state, each under the profiler (2
    # calls): forward + backward, the probe, the optimizer (lr 0).  The
    # update consumes its state (it moves the moments in place): it runs
    # on the last state, which nothing reads after this; cloned moments
    # would add 20 GB at this width
    st = box["state"]
    g = loss_and_grads(st.params, batch, cfg)[2]
    parts = {
        "forward_backward": steps_profile(torch, lambda: loss_and_grads(
            st.params, batch, cfg)[0], 2)[1],
        "grad_probe": steps_profile(torch, lambda: grad_payload_stats(
            g, spec_new)["coded_bits"], 2)[1],
        "adamw": steps_profile(torch, lambda: adamw_update(
            g, st.opt, st.params, AdamWConfig(lr=0.0))[2]["lr"], 2)[1]}
    del g, st
    need(losses[-1] < losses[0] and all(map(math.isfinite, losses)),
         f"train: the loss on a repeated batch did not fall: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del box, state, run, extra
    torch.cuda.empty_cache()

    # ---- the reduced config: one step on the card and one on the CPU's
    # plain path from the same params and batch, within STEP_TOL
    rcfg = cfg.reduced()
    rparams = model_init(rcfg, torch.Generator().manual_seed(SEED),
                         device="cpu")
    rbatch = next(SyntheticDataset(rcfg, DataConfig(TRAIN_BATCH, 32,
                                                    seed=SEED)))
    step = make_train_step(rcfg, AdamWConfig(lr=TRAIN_LR))
    out = {}
    for where in ("cpu", dev):
        st = train_state_init(tree_map(lambda t: t.to(where), rparams))
        new, m = step(st, {k: torch.from_numpy(v).to(where)
                           for k, v in rbatch.items()})
        out[str(where)] = (tree_map(lambda t: t.cpu(), new.params),
                           float(m["loss"]), float(m["grad_norm"]))
    (pc, lc, gc), (pd, ld, gd) = out["cpu"], out[str(dev)]
    card_vs_cpu = step_deviation({"loss": ld, "grad_norm": gd, "params": pd},
                                 {"loss": lc, "grad_norm": gc, "params": pc},
                                 TRAIN_LR)
    need(all(v <= STEP_TOL[k] for k, v in card_vs_cpu.items()),
         f"train: reduced step, card vs CPU beyond STEP_TOL: {card_vs_cpu} "
         f"(loss {ld} / {lc}, grad norm {gd} / {gc})")

    secs = sorted(s["step_seconds"] for s in steps)
    med = secs[len(secs) // 2]
    b5_ms = sum(v for k, v in prof["port_kernels_ms_per_step"].items()
                if "hist" in k)
    rec = {
        "model": cfg.name, "params": n_params, "batch": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "refresh_every": TRAIN_REFRESH, "lr": TRAIN_LR,
        "losses": [s["loss"] for s in steps],
        "book_epochs": epochs, "refreshed_epoch": mgr.book_epoch,
        "refreshes": refreshes,
        "n_recompiles": mgr.n_recompiles,
        "step_ms_median": med * 1e3, "step_ms_all": [s * 1e3 for s in secs],
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / med,
        "profile": prof, "parts": parts, "host_syncs_a_step": step_syncs,
        "b5_device_ms_per_step": b5_ms,
        "b5_share_of_device": b5_ms / prof["device_busy_ms_per_step"],
        "grad_coded_over_raw_bootstrap": ratio_boot,
        "grad_coded_over_raw_refreshed": ratio_new,
        "repeated_batch_lr": TRAIN_LR / 10, "repeated_batch_losses": losses,
        "peak_memory_gb": peak_gb,
        "reduced_card_vs_cpu": {"loss": [ld, lc], "grad_norm": [gd, gc],
                                "deviation": card_vs_cpu,
                                "limits": {k: STEP_TOL[k]
                                           for k in card_vs_cpu}},
        "seconds": time.perf_counter() - t_phase,
    }
    return rec, launches


# -------------------------------------------------- lifecycle phase
LIFE_NEW, LIFE_REFRESH = 16, 4


def lifecycle_phase(torch, dev, params, cfg, books, prompts, card, build):
    """Phase 8: ``launch.dryrun.drift_check`` at 8 ranks on the card and
    the wire serve with book hot-refresh (see the module docstring).
    Returns the record and the path's launch counts."""
    from repro_torch.launch.dryrun import drift_check
    from repro_torch.lifecycle import BookLifecycleManager, DriftThresholds
    from repro_torch.serve import Engine, ServeConfig

    t_phase = time.perf_counter()
    mgr = BookLifecycleManager(thresholds=DriftThresholds(
        kl_bits=0.0, excess_bits=0.0, min_symbols=1, patience=1))
    for p, b in books.items():                  # the wire serve's books
        mgr.install(("act", "bf16", p), b.source_counts)
    spec = mgr.spec("act", "bf16", mode="bitexact", transport="chunked",
                    chunk=CHUNK, decode_backend="multisym")
    sc = ServeConfig(max_cache_len=PROMPT + LIFE_NEW)
    # ---- the path: launch counts reset just before, read after
    torch.cuda.synchronize()
    build.reset_launches()
    drift = drift_check(n=8, device=dev)
    eng = Engine(params, cfg, sc, spec, lifecycle=mgr,
                 refresh_every=LIFE_REFRESH, device=dev)
    t0 = time.perf_counter()
    toks, totals = eng.generate(prompts, LIFE_NEW)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    print(f"lifecycle path: {time.perf_counter() - t_phase:.1f} s, "
          f"launches {launches} [{card}]")

    need(drift["status"] == "ok" and all(
        v for v in drift.values() if isinstance(v, bool)),
        f"drift_check on the card: {drift}")
    need(totals["book_refreshes"] >= 1, f"hot refresh: no refresh in "
         f"{LIFE_NEW} tokens ({totals})")
    need(totals["act_decode_mismatch"] == 0.0,
         f"hot refresh: {totals['act_decode_mismatch']} mismatches")
    steps = eng.step_metrics
    for i, m in enumerate(steps):               # the books of its epoch
        in_force = eng.epoch_specs[int(m["book_epoch"])]
        want = sum(int((m[f"act_hist_{p}"].astype("int64")
                        * in_force.lengths_for(p)).sum())
                   for p in ("lo", "hi"))
        need(m["act_decoded_bits"] == m["act_coded_bits"] == float(want),
             f"hot refresh step {i} (epoch {m['book_epoch']}): B2 bits "
             f"{m['act_decoded_bits']} != B5 . lengths {want}")
    for k in ("encode_lookup", "pack_blocks", "histogram256",
              "decode_chunks_multisym"):
        need(launches[k] > 0, f"lifecycle: kernel {k} was not launched")
    plain = Engine(params, cfg, sc, spec, device=dev)
    toks_plain, _ = plain.generate(prompts, LIFE_NEW)
    need((toks == toks_plain).all(), "hot refresh: the tokens differ from "
         "the engine's without lifecycle=")
    epochs = [m["book_epoch"] for m in steps]
    rec = {"drift_check": drift, "new_tokens": LIFE_NEW,
           "refresh_every": LIFE_REFRESH,
           "book_refreshes": totals["book_refreshes"],
           "book_epochs": epochs, "n_recompiles": mgr.n_recompiles,
           "coded_over_raw_by_step": [m["act_coded_bits"]
                                      / m["act_raw_bits"] for m in steps],
           "generate_s": wall,
           "step_ms_median": sorted(m["step_seconds"] for m in steps)[
               len(steps) // 2] * 1e3,
           "seconds": time.perf_counter() - t_phase}
    print(f"hot refresh: {totals['book_refreshes']:g} refreshes, epochs "
          f"{epochs}, tokens = plain engine's, every step lossless "
          f"[{card}]")
    return rec, launches


def b_decode(book, words, sym):
    """A monolithic stream's decode through the book's codec (B4 for a
    Huffman book, B6 for QLC)."""
    from repro_torch.core.encoder import decode_with_book
    return decode_with_book(words, book, sym.numel())


def histogram_np(torch, sym):
    """A plane's 256-bin counts as numpy (B5 on the card)."""
    from repro_torch.comm.compression import histogram256
    return histogram256(sym).cpu().numpy()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
