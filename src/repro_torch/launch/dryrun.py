"""The compressed-ring and compressed-at-rest checks (port of
``repro.launch.dryrun``'s ``--ring-check`` and ``--memstore-check``; the
reference's other checks wait for their slices).

    python -m repro_torch.launch.dryrun --ring-check [--device cpu]
        [--codec huffman|qlc]
    python -m repro_torch.launch.dryrun --memstore-check [--device cpu]

``ring_check`` runs the ring collectives (``comm.ring``,
``comm.hierarchy``) on a loopback axis of n ranks (payload 4096 a rank,
chunk 512, integer-valued bf16, so every ring order sums exactly) and
holds ring_all_reduce, ring_all_gather, ring_reduce_scatter,
ring_all_to_all and the 2 × n/2 hierarchical all_reduce to plain torch
sums, gathers and permutes, and the ledgers to the analytic volumes:
2(n−1)/n for all_reduce, (n−1)/n for reduce_scatter and all_to_all, the
sum of the per-axis terms for the hierarchy.  ``--codec`` picks the
books' codec.

``memstore_check`` proves the compressed-at-rest serving path end to end
under both registered codecs, on CUDA unless the caller names the CPU:

  1. ``CompressedParamStore.from_tree`` codes every large bf16 leaf
     (books from B5 histograms, encode by B1 + B2), ``footprint`` shows
     its ratio, and ``materialize_tree`` (B4 or B6) gives back the
     parameters bit for bit;
  2. the fused ``decode_matmul`` (B7 or B8) on an odd 37 x 10 weight at
     chunk 70 equals its plain version bit for bit, tiles included;
  3. ``CodedKVStore`` round-trips the prompt's prefill cache bit-exact,
     and a decode step on the round-tripped cache gives bit-identical
     logits to the raw cache's;
  4. an Engine serving from the store with ``kv_mode="coded"`` generates
     the same greedy tokens as a raw engine, with non-zero ledgers.

The default model is the reference's small ``memck`` (random weights
from seed 0); a caller passes another config and its parameters (the
chip script passes ``gemma2-2b`` at full width).  On CUDA the record
also holds each stage's seconds, the coded decode steps' times, the
kernel launches of each codec's run, and one coded step's host syncs
(counted under torch's sync debug mode) and launches.  It exits 1 on any
divergence.
"""
from __future__ import annotations

import argparse
import json
import time
import warnings
from typing import Any, Dict, Optional

import torch

from ..device import resolve_device

__all__ = ["ring_check", "memstore_check", "memck_config", "main"]


def ring_check(n: int = 8, payload: int = 4096, chunk: int = 512,
               codec: str = "huffman", *, device=None,
               verbose: bool = True) -> Dict[str, Any]:
    """Run the ring collectives on a loopback axis of ``n`` ranks and
    check them bit for bit against plain torch collectives, with the
    measured ledgers against the analytic ring volumes (the reference's
    ``ring_collective_check`` on one device).  On CUDA every hop runs the
    kernels; ``device="cpu"`` runs their plain versions."""
    import numpy as np
    from ..comm import (LoopbackAxis, hierarchical_all_reduce,
                        hierarchical_wire_factor, loopback_mesh,
                        ring_all_gather, ring_all_reduce, ring_all_to_all,
                        ring_reduce_scatter)
    from ..core.codebook import build_codebook
    from ..core.symbols import SCHEMES
    dev = resolve_device(device)
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(-2, 3, (n, payload), generator=gen).to(
        torch.bfloat16).to(dev)
    books = {p: build_codebook(np.bincount(s.cpu().numpy(), minlength=256),
                               codec=codec)
             for p, s in SCHEMES["bf16"].to_symbols(x).items()}
    ax = LoopbackAxis(n)

    yr, sr = ring_all_reduce(x, ax, books, "bf16", chunk=chunk,
                             decode_backend="scan")
    yg, _ = ring_all_gather(x[:, None], ax, books, "bf16", chunk=chunk,
                            decode_backend="scan")
    # the other ops run the codec's default ("auto") hop decode
    ys, ss = ring_reduce_scatter(x, ax, books, "bf16", chunk=chunk)
    ya, sa = ring_all_to_all(x.reshape(n, n, -1), ax, books, "bf16",
                             chunk=chunk)
    total = x.float().sum(0)

    def exact(a, b) -> bool:
        return bool(torch.equal(a.float(), b.float()))

    ar_exact = exact(yr, total.expand(n, -1))
    ag_exact = exact(yg, x.expand(n, n, payload))
    rs_exact = exact(ys, total.reshape(n, -1))
    a2a_exact = exact(ya, x.reshape(n, n, -1).transpose(0, 1))

    # the hierarchical two-axis ring on a (2 × n//2) stack of ranks
    n2, n1 = 2, n // 2
    mesh = loopback_mesh({"outer": n2, "inner": n1})
    xh = torch.randint(-2, 3, (n2, n1, payload), generator=gen).to(
        torch.bfloat16).to(dev)
    yh, sh = hierarchical_all_reduce(xh, (mesh["inner"], mesh["outer"]),
                                     books, "bf16", chunk=chunk)
    hier_exact = exact(yh, xh.float().sum((0, 1)).expand(n2, n1, -1))

    def glob(stats, k) -> float:      # a caller's psum of a replicated stat
        return float(stats[k].sum())

    S = payload * 16
    raw = {"ar": glob(sr, "raw_wire_bits"), "rs": glob(ss, "raw_wire_bits"),
           "a2a": glob(sa, "raw_wire_bits"),
           "hier": glob(sh, "raw_wire_bits")}
    analytic = {"ar": 2.0 * (n - 1) * S, "rs": (n - 1) * S,
                "a2a": (n - 1) * S,
                "hier": (n1 * n2) * hierarchical_wire_factor(n1, n2) * S}
    volumes_ok = all(abs(raw[k] - analytic[k]) < 1e-3 for k in raw)
    exact_all = ar_exact and ag_exact and rs_exact and a2a_exact and hier_exact
    rec = {
        "kind": "ring_check", "axis": f"loopback {n}", "n_ranks": n,
        "device": str(dev), "payload_elems": payload, "chunk": chunk,
        "codec": codec, "bitexact_all_reduce": ar_exact,
        "bitexact_all_gather": ag_exact, "bitexact_reduce_scatter": rs_exact,
        "bitexact_all_to_all": a2a_exact, "bitexact_hierarchical": hier_exact,
        **{f"{k}_raw_wire_bits": v for k, v in raw.items()},
        **{f"{k}_analytic_raw_bits": v for k, v in analytic.items()},
        "ar_coded_wire_bits": glob(sr, "coded_wire_bits"),
        "ar_hops": round(glob(sr, "hops")),
        "hier_axes": f"{n2}x{n1}", "hier_hops": round(glob(sh, "hops")),
        "seconds": time.perf_counter() - t0,
        "status": "ok" if exact_all and volumes_ok else "FAILED",
    }
    if verbose:
        print(f"[dryrun] ring-check n={n} payload={payload} codec={codec} "
              f"device={dev} bitexact(ar/ag/rs/a2a/hier)={ar_exact}/"
              f"{ag_exact}/{rs_exact}/{a2a_exact}/{hier_exact} coded/raw="
              f"{rec['ar_coded_wire_bits'] / raw['ar']:.3f} "
              f"status={rec['status']}", flush=True)
    return rec


def memck_config():
    """The reference's ``memck`` model: 2 ``attn`` layers, d 128."""
    from ..models import BlockGroup, ModelConfig
    return ModelConfig(name="memck", arch_type="dense", d_model=128,
                       vocab_size=512, blocks=(BlockGroup(("attn",), 2),),
                       n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)


def _trees_equal(a, b) -> bool:
    from ..checkpoint.ckpt import _flatten
    fa, fb = _flatten(a), _flatten(b)
    return list(fa) == list(fb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(fa.values(), fb.values()))


def _clone(tree):
    from ..models.common import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fused_case(codec: str, dev) -> Dict[str, Any]:
    """B7/B8 on the reference's odd case (37 x 10 at chunk 70, a tail
    chunk and a ragged group) against the plain version on the CPU."""
    from ..kernels import ops
    from ..memstore import CompressedParamStore
    gen = torch.Generator().manual_seed(1)
    w = (torch.randn((37, 10), generator=gen) * 0.02).to(torch.bfloat16)
    x = torch.randn((4, 37), generator=gen).to(torch.bfloat16)
    ws = CompressedParamStore.from_tree({"w": w.to(dev)}, codec=codec,
                                        chunk=70, min_size=1, device=dev)
    y, tiles = ws.matmul(x.to(dev), "w", tiles=True)
    lo, hi, counts = ws.plane_blocks("w")
    y_plain, t_plain = ops.decode_matmul(x, lo.cpu(), hi.cpu(), counts.cpu(),
                                         ws.books, chunk=70, n_cols=10,
                                         tiles=True)
    exact = (torch.equal(y.cpu().view(torch.int32),
                         y_plain.view(torch.int32))
             and torch.equal(tiles.cpu().view(torch.int16),
                             t_plain.view(torch.int16))
             and torch.equal(t_plain.reshape(-1)[:370].view(torch.int16),
                             w.reshape(-1).view(torch.int16)))
    err = float((y.cpu() - x.float() @ w.float()).abs().max())
    return {"fused_decode_matmul_bitexact": bool(exact),
            "fused_vs_dense_max_abs_err": err}


def _count_step(eng, tok, caches, pos: int) -> Dict[str, Any]:
    """One coded decode step of ``eng`` after the prefill ``caches``
    (model step, ingest of the new slot, read), on CUDA with torch's
    sync debug mode set to warn: its host syncs and kernel launches."""
    from ..kernels.build import LAUNCHES
    eng._kv = eng._make_kvstore()
    eng._kv.ingest(caches)
    caches = eng._kv.read(caches)
    before = dict(LAUNCHES)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            logits, caches, _ = eng._step(eng.params, tok, caches, pos)
            eng._kv.ingest(caches)
            eng._kv.read(caches)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    return {"host_syncs": syncs,
            "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                         if LAUNCHES[k] != before[k]}}


def memstore_check(cfg=None, params=None, *, device=None, batch: int = 2,
                   prompt_len: int = 8, new_tokens: int = 8,
                   verbose: bool = True) -> Dict[str, Any]:
    """Prove the compressed-at-rest path under both codecs (see the
    module docstring).  ``cfg`` / ``params``: the model (default: memck
    with weights from seed 0).  Returns the record; ``status`` is "ok"
    only if every check held."""
    from ..kernels.build import LAUNCHES
    from ..memstore import CodedKVStore, CompressedParamStore
    from ..models import decode_step, model_init, prefill
    from ..serve.engine import Engine, ServeConfig

    dev = resolve_device(device)
    t_all = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if cfg is None:
        cfg = memck_config()
    if params is None:
        params = model_init(cfg, gen, device=dev)
    serve_cfg = ServeConfig(max_cache_len=prompt_len + new_tokens)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    with torch.no_grad():
        raw_eng = Engine(params, cfg, serve_cfg, device=dev)
        toks_raw, _ = raw_eng.generate(prompt, new_tokens)
        del raw_eng
        logits0, caches = prefill(params, {"tokens": prompt}, cfg,
                                  serve_cfg.max_cache_len)
    tok = logits0[:, -1].argmax(-1)[:, None]

    rec: Dict[str, Any] = {"kind": "memstore_check", "model": cfg.name,
                           "device": str(dev), "batch": batch,
                           "prompt_len": prompt_len,
                           "new_tokens": new_tokens}
    ok = True
    for codec in ("huffman", "qlc"):
        sec: Dict[str, float] = {}
        before = dict(LAUNCHES)

        def stage(name, fn):
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            sec[name] = time.perf_counter() - t0
            return out

        with torch.no_grad():
            store = stage("store_from_tree", lambda: CompressedParamStore
                          .from_tree(params, codec=codec, device=dev))
            fp = store.footprint()
            store_exact = stage("materialize_tree", lambda: _trees_equal(
                params, store.materialize_tree()))
            fused = stage("fused_decode_matmul",
                          lambda: _fused_case(codec, dev))

            kv = CodedKVStore(codec=codec, device=dev)
            rt = stage("kv_round_trip",
                       lambda: (kv.ingest(caches), kv.read(caches))[1])
            kv_exact = _trees_equal(caches, rt)
            l_raw, _ = decode_step(params, tok, _clone(caches), prompt_len,
                                   cfg)
            l_rt, _ = decode_step(params, tok, rt, prompt_len, cfg)
            logits_exact = torch.equal(l_raw.view(torch.int16),
                                       l_rt.view(torch.int16))
            del rt, l_raw, l_rt

            eng = stage("engine_init", lambda: Engine(
                None, cfg, serve_cfg, param_store=store, kv_mode="coded",
                device=dev))
            toks_c, totals = stage("generate", lambda: eng.generate(
                prompt, new_tokens))
            tokens_equal = bool((toks_c == toks_raw).all())
            read_chunks = sum(eng._kv.last_read_chunks.values())
            steps = sorted(m["step_seconds"] for m in eng.step_metrics)
            launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                        if LAUNCHES[k] != before[k]}
            step_count = (_count_step(eng, tok, caches, prompt_len)
                          if dev.type == "cuda" else None)
        hbm = {k: v for k, v in totals.items() if "hbm" in k}
        codec_ok = (store_exact and fused["fused_decode_matmul_bitexact"]
                    and kv_exact and logits_exact and tokens_equal
                    and hbm["hbm_raw_bits"] > 0 and hbm["hbm_coded_bits"] > 0)
        ok = ok and codec_ok
        rec[codec] = {
            "store_bitexact": store_exact,
            "param_hbm_ratio": float(fp["ratio"]),
            **fused,
            "kv_bitexact": kv_exact,
            "kv_hbm_ratio": (kv.kv_hbm_coded_bits / kv.kv_hbm_raw_bits
                             if kv.kv_hbm_raw_bits else 0.0),
            "coded_serve_logits_bitexact": logits_exact,
            "coded_serve_tokens_equal": tokens_equal,
            "hbm": hbm,
            "seconds": sec,
            "coded_step_ms_median": (steps[len(steps) // 2] * 1e3
                                     if steps else None),
            "coded_steps": len(steps),
            "kv_last_read_chunks": read_chunks,
            "launches": launches,
            "one_coded_step": step_count,
        }
        if verbose:
            print(f"[dryrun] memstore-check codec={codec} "
                  f"store/fused/kv/logits/tokens={store_exact}/"
                  f"{fused['fused_decode_matmul_bitexact']}/{kv_exact}/"
                  f"{logits_exact}/{tokens_equal} param ratio "
                  f"{fp['ratio']:.4f} hbm coded/raw "
                  f"{hbm['hbm_coded_bits'] / hbm['hbm_raw_bits']:.4f}",
                  flush=True)
        del store, eng, kv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_all
    rec["status"] = "ok" if ok else "FAILED"
    if verbose:
        print(f"[dryrun] memstore-check status={rec['status']}", flush=True)
    return rec


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring-check", action="store_true",
                    help="run the ring collectives and the hierarchical "
                         "ring on a loopback axis; bit-check them against "
                         "plain torch collectives")
    ap.add_argument("--codec", default="huffman",
                    help="entropy codec for --ring-check books")
    ap.add_argument("--memstore-check", action="store_true",
                    help="prove the compressed-at-rest memory path: store "
                         "and KV round trips, fused decode_matmul vs its "
                         "plain version, and coded-serve == raw-serve")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--out", default=None, help="write the record as JSON")
    args = ap.parse_args(argv)
    if not (args.memstore_check or args.ring_check):
        ap.error("nothing to do: pass --ring-check or --memstore-check")
    rec = {}
    if args.ring_check:
        rec["ring_check"] = ring_check(codec=args.codec,
                                       device=args.device)
    if args.memstore_check:
        rec["memstore_check"] = memstore_check(device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    if any(r["status"] != "ok" for r in rec.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
