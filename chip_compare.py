#!/usr/bin/env python3
"""Time the chunk walkers B3 and B4 of this tree against another
checkout's and against design variants of ``csrc/decode.cu``, in turns,
on one CUDA card.

    python3 chip_compare.py --parent DIR [--rounds N]

DIR holds a checkout of the commit to compare with (``git archive`` of
it unpacked); its ``src/repro_torch/kernels/csrc/decode.cu`` is built
with nvcc beside this tree's, and so are the variants below, each a
copy of this tree's source with one edit.  Every library's C entry is
called on the same tensors (the warm-up logits planes of ``gemma2-2b``
from seed 0, as ``chip_smoke.py`` draws them, and ``w_gate[0]``'s hi
plane), held to the plain version, and timed in turns (A, B, ..., B, A
a round): device ms by the profiler's kernel events and CUDA-events ms,
20 calls each.  Variants:

* ``general``: the default LUT (K = 13, s_max = 8) through B4's general
  kernel (K read at run time, the 15-length search) in place of the
  kernel with K compiled in;
* ``b3_constant_shifts``: B3's canonical search taking each length's
  code by a constant shift of the window, as B4's does.

Prints one JSON line per comparison and ends with ``{"card": ...,
"turns": ...}``; exits non-zero without CUDA or on any mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc"
VARIANTS = {
    "general": ("  if (k == kMsK && row == 8)\n    return ms_launch<kMsK, 8>",
                "  if (false)\n    return ms_launch<kMsK, 8>"),
    "b3_constant_shifts": (
        "CanonicalSearch<kPrefixBits + 1, kMaxLen - kPrefixBits> search;",
        "CanonicalSearch<kPrefixBits + 1, kMaxLen - kPrefixBits, true> "
        "search;"),
}


def start_build(build, name: str, src_dir: Path, edit=None):
    """Copy ``src_dir`` (a csrc directory) under the build directory,
    apply ``edit`` (old, new) to its decode.cu and start nvcc on it."""
    d = build.build_dir() / "compare" / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(src_dir, d)
    if edit:
        src = (d / "decode.cu").read_text()
        if edit[0] not in src:
            raise SystemExit(f"variant {name}: decode.cu no longer holds "
                             f"{edit[0]!r}")
        (d / "decode.cu").write_text(src.replace(edit[0], edit[1]))
    lib = d / "libdecode.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.FLAGS, "-I", str(d), "-o", str(lib),
         str(d / "decode.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, proc, lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_compare.py needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.comm.compression import histogram256
    from repro_torch.configs import get_config
    from repro_torch.core.codebook import (build_codebook,
                                           multisym_device_tables)
    from repro_torch.core.encoder import chunk_counts_for
    from repro_torch.core.symbols import SCHEMES, bf16_planes
    from repro_torch.kernels import build, decode, ops
    from repro_torch.kernels.build import I, P
    from repro_torch.models import model_init, prefill

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    print(card)
    dev = torch.device("cuda", 0)
    jobs = [start_build(build, "parent", args.parent / CSRC)]
    jobs += [start_build(build, n, ROOT / CSRC, e)
             for n, e in VARIANTS.items()]
    build.build_all(["decode"])
    libs = {"change": build.library("decode")}
    for name, proc, lib in jobs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            print(f"nvcc failed on {name}:\n{out}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(lib))

    cfg = get_config("gemma2-2b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    with torch.no_grad():
        params = model_init(cfg, gen, device=dev)
        warm = torch.randint(0, cfg.vocab_size, (cs.BATCH, cs.PROMPT),
                             generator=gen, device=dev)
        logits, _ = prefill(params, {"tokens": warm}, cfg,
                            cs.PROMPT + cs.NEW)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in SCHEMES["bf16"].to_symbols(logits).items()}
    step = SCHEMES["bf16"].to_symbols(logits[:, -1].to(torch.bfloat16))
    planes = {f"logits {p}": (step[p], books[p]) for p in ("lo", "hi")}
    gate = bf16_planes(params["groups"][0][0]["ffn"]["w_gate"][0])["hi"]
    planes["w_gate[0] hi"] = (gate, build_codebook(
        histogram256(gate).cpu().numpy()))
    del params, logits
    torch.cuda.empty_cache()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def entry(lib, name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def b4_call(lib, words, counts, canon, rows, meta, out):
        fn = entry(lib, "decode_multisym_launch",
                   [P] * 8 + [I, P] + [I] * 6 + [P])
        a = (words.data_ptr(), counts.data_ptr(), rows.data_ptr(),
             meta.data_ptr(), *(t.data_ptr() for t in canon),
             canon[3].numel(), out.data_ptr(), words.shape[0], cs.CHUNK,
             words.shape[1], 13, 8, 16, stream)
        return lambda: fn(*a)

    def b3_call(lib, words, counts, canon, pre, out):
        fn = entry(lib, "decode_canonical_launch",
                   [P] * 7 + [I, P] + [I] * 4 + [P])
        a = (words.data_ptr(), counts.data_ptr(), pre.data_ptr(),
             *(t.data_ptr() for t in canon), canon[3].numel(),
             out.data_ptr(), words.shape[0], cs.CHUNK, words.shape[1], 16,
             stream)
        return lambda: fn(*a)

    def turns(tag, key, calls, want):
        runs = {}
        for n, (call, out) in calls.items():
            def run(call=call, out=out, n=n):
                err = call()
                if err:
                    raise RuntimeError(f"{tag} {n}: cudaError_t {err}")
                return out
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{tag} {n}: differs from the plain "
                                   "version")
            runs[n] = run
        res = {n: [] for n in runs}
        order = list(runs) + list(runs)[::-1]
        for _ in range(args.rounds):
            for n in order:
                ev = cs.device_events(torch, runs[n], 20)
                kern = [v for name, v in ev.items() if key in name]
                d_ms = (sum(us for us, _ in kern) / 1e3 / 20
                        if sum(c for _, c in kern) == 20 else None)
                res[n].append({"device_ms": d_ms,
                               "ms": cs.cuda_ms(torch, runs[n], 20)})
        print(json.dumps({"card": card, "comparison": tag, "turns": res}),
              flush=True)
        return res

    record = {}
    for tag, (sym, book) in planes.items():
        words, _ = ops.encode_with_book(sym, book, chunk=cs.CHUNK)
        counts = torch.from_numpy(chunk_counts_for(sym.numel(),
                                                   cs.CHUNK)).to(dev)
        canon = book.device_tables("canonical", dev)
        syms, meta = multisym_device_tables(book.multisym_tables(), dev)
        want = decode.decode_chunks_multisym_plain(words, counts, syms, meta,
                                                   *canon, chunk=cs.CHUNK)
        calls = {}
        for n in ("parent", "change", "general"):
            out = torch.empty_like(want)
            calls[n] = (b4_call(libs[n], words, counts, canon, syms, meta,
                                out), out)
        record[f"B4 {tag}"] = turns(f"B4 {tag}", "multisym", calls, want)
        if tag.startswith("logits"):
            (pre,) = book.device_tables("prefix", dev)
            want = decode.decode_chunks_canonical_plain(
                words, counts, *canon, chunk=cs.CHUNK)
            calls = {}
            for n in ("parent", "change", "b3_constant_shifts"):
                out = torch.empty_like(want)
                calls[n] = (b3_call(libs[n], words, counts, canon, pre, out),
                            out)
            record[f"B3 {tag}"] = turns(f"B3 {tag}", "canonical", calls,
                                        want)
    print(json.dumps({"card": card, "turns": record}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
