"""The perf hillclimb over the sharding plan (port of
``repro.launch.hillclimb``): hypothesis → change → re-plan → compare.

Four pairs, each the full-size config on the single-pod 16 × 16 mesh
of H100s (``launch.mesh``):

  qwen3-4b × train_4k          the collective-bound one (residual-stream
                                all-reduces × the remat re-forward)
  deepseek-v3-671b × train_4k  MoE all-to-all + DP gradients, and a
                                model that fits only when sharded
                                (ZeRO-1, FSDP)
  mamba2-780m × train_4k       the least useful-FLOPs fraction (the SSD
                                chunk's quadratic), and data parallelism
                                alone
  command-r-plus-104b × train_4k  gradient accumulation against the wire

Each iteration re-plans the pair (``launch.dryrun.plan_combo``: meta
tensors and partition specs, no device) with the reference's change —
a config patch, ``grad_accum``, ``opt_sharding`` (``zero1``) or
``param_sharding`` (``fsdp``, ``dp_only``) — and re-derives the three
roofline terms.  The last two iterations of a pair scale the best
record's collective term and wire bytes by the reference's measured
coded/raw ratios of the fixed-codebook wire (``RATIO_PAPER``: one
interleaved book; ``RATIO_PLANE_SPLIT``: a book a byte plane).  The
iterations, hypotheses and ratios are the reference's, word for word;
the hypotheses speak of XLA's partitioner, whose collective schedule
the port's ``roofline.collectives`` does not reproduce, so the port's
records may bear a hypothesis out or not.

    python -m repro_torch.launch.hillclimb [--pair qwen3]
        [--out results/hillclimb.json]

``--out`` keeps the records of a pair that has at least 5 and replans
the others.  ``python -m repro_torch.roofline.perf_log_md <out>``
renders them.
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace
from typing import Any, Dict, List, Optional

__all__ = ["RATIO_PAPER", "RATIO_PLANE_SPLIT", "PAIRS", "run_pair", "main"]

# The reference's measured wire-compression ratios (coded/raw) on its
# Gemma SFT proxy: one interleaved codebook (the paper's) and per-byte-
# plane codebooks.
RATIO_PAPER = 0.822
RATIO_PLANE_SPLIT = 0.715

PAIRS = ("qwen3-4b/train_4k", "deepseek-v3-671b/train_4k",
         "mamba2-780m/train_4k", "command-r-plus-104b/train_4k")


def _apply_compression(rec: Dict[str, Any], ratio: float, label: str
                       ) -> Dict[str, Any]:
    out = dict(rec)
    out["collective_s"] = rec["collective_s"] * ratio
    out["wire_bytes"] = rec["wire_bytes"] * ratio
    terms = {"compute": out["analytic_compute_s"],
             "memory": out["analytic_memory_s"],
             "collective": out["collective_s"]}
    out["bottleneck"] = max(terms, key=terms.get)
    out["roofline_step_s"] = max(terms.values())
    out["note"] = (out.get("note", "") + f" +wire-compression({label}, "
                   f"ratio={ratio})").strip()
    return out


def run_pair(pair: str, out_records: List[Dict[str, Any]],
             flush=None) -> None:
    """Append the records of ``pair``'s iterations to ``out_records``
    (``flush()`` after each)."""
    from ..configs import get_config
    from .dryrun import plan_combo

    def go(name: str, hypothesis: str, **kw):
        print(f"\n=== {pair} :: {name}", flush=True)
        print(f"    hypothesis: {hypothesis}", flush=True)
        cfg_patch = kw.pop("cfg_patch", None)
        compress = kw.pop("compress", None)
        base_rec = kw.pop("base_rec", None)
        if compress is not None:
            ratio, label = compress
            rec = _apply_compression(base_rec, ratio, label)
        else:
            cfg = get_config(pair.split("/")[0])
            if cfg_patch:
                cfg = replace(cfg, **cfg_patch)
            rec = plan_combo(pair.split("/")[0], pair.split("/")[1],
                             cfg_override=cfg, verbose=False, **kw)
        rec["iteration"] = name
        rec["pair"] = pair
        rec["hypothesis"] = hypothesis
        hbm = rec.get("bytes_per_device", {}).get("peak_hbm_est", 0)
        print(f"    compute={rec['analytic_compute_s']:.3f}s "
              f"memory={rec['analytic_memory_s']:.3f}s "
              f"collective={rec['collective_s']:.3f}s "
              f"→ bottleneck={rec['bottleneck']} "
              f"step≥{rec['roofline_step_s']:.3f}s "
              f"hbm={hbm / 1e9:.1f}GB/dev", flush=True)
        out_records.append(rec)
        if flush is not None:
            flush()
        return rec

    arch, shape = pair.split("/")

    if arch == "qwen3-4b":
        base = go("baseline", "paper-faithful baseline (remat=block): "
                  "6 residual-AR sites/layer incl. remat re-forward")
        it1 = go("remat=save_mixer_ffn",
                 "saving post-collective mixer/ffn outputs removes the "
                 "2 re-forward AR sites of 6 → collective −~33%",
                 cfg_patch={"remat": "save_mixer_ffn"})
        go("ga1",
           "grad_accum 2→1 halves scan trips but doubles per-trip "
           "payload → wire unchanged; memory term grows (activations "
           "×2); expect no collective win (refutation probe)",
           cfg_patch={"remat": "save_mixer_ffn"}, grad_accum=1)
        best = min((base, it1), key=lambda r: r["collective_s"])
        go("paper: fixed-codebook wire compression",
           "paper technique on the remaining AR payloads: coded/raw = "
           f"{RATIO_PAPER} (measured, fig4) → collective × {RATIO_PAPER}",
           compress=(RATIO_PAPER, "paper-interleaved"), base_rec=best)
        go("beyond-paper: plane-split codebooks",
           "per-byte-plane books beat one interleaved book: ratio "
           f"{RATIO_PLANE_SPLIT} (measured, fig4ext)",
           compress=(RATIO_PLANE_SPLIT, "plane-split"), base_rec=best)

    elif arch == "deepseek-v3-671b":
        go("baseline", "paper-faithful baseline: params+Adam "
           "replicated over data → ~430 GB/device, 27× over HBM; "
           "scatter-MoE makes SPMD all-reduce the (E,C,d) buffers "
           "across data shards → collective blow-up")
        go("moe=eshard",
           "expert-sharded MoE: each model shard runs its E/16 "
           "local experts on its data shard's tokens; one psum "
           "combines → MoE wire collapses from (E,C,d)-buffer ARs "
           "to one (tokens,d) AR per block (~100× less)",
           cfg_patch={"moe_impl": "eshard"})
        go("eshard+zero1",
           "shard Adam m/v (f32, 8N bytes) over data(16): optimizer "
           "bytes /16 (params still replicated)",
           cfg_patch={"moe_impl": "eshard"}, opt_sharding="zero1")
        it3 = go("eshard+zero1+fsdp",
                 "also shard params over data (ZeRO-3): param bytes /16 → "
                 "fits multi-pod HBM; adds per-layer all-gather wire",
                 cfg_patch={"moe_impl": "eshard"},
                 opt_sharding="zero1", param_sharding="fsdp")
        it4 = go("eshard+zero1+fsdp+save_mixer_ffn",
                 "drop remat re-forward ARs on top of FSDP",
                 opt_sharding="zero1", param_sharding="fsdp",
                 cfg_patch={"moe_impl": "eshard",
                            "remat": "save_mixer_ffn"})
        best = min((it3, it4), key=lambda r: r["roofline_step_s"])
        go("paper: fixed-codebook wire compression",
           "compress MoE dispatch + grad + FSDP-gather payloads: ratio "
           f"{RATIO_PAPER} (measured)",
           compress=(RATIO_PAPER, "paper-interleaved"), base_rec=best)
        go("beyond-paper: plane-split codebooks",
           f"plane-split ratio {RATIO_PLANE_SPLIT} (measured)",
           compress=(RATIO_PLANE_SPLIT, "plane-split"), base_rec=best)

    elif arch == "command-r-plus-104b":
        go("baseline(ga=16)",
           "paper-faithful baseline: ga=16 needed for activation "
           "memory, but XLA reduces weight-grad partial sums per "
           "microbatch → wire ∝ ga (qwen3 lesson transfers?)")
        it1 = go("ga=4",
                 "4× fewer accumulation trips → predict wire ÷4 "
                 "(~25.3 TB → ~6.3 TB); activation memory ×4 (watch HBM)",
                 grad_accum=4)
        it2 = go("ga=4+save_mixer_ffn",
                 "drop remat re-forward AR sites on top",
                 grad_accum=4, cfg_patch={"remat": "save_mixer_ffn"})
        it3 = go("ga=4+save_mixer_ffn+zero1",
                 "Adam moments over data: 397 GB/dev → ~120 GB "
                 "(capacity move; wire unchanged)",
                 grad_accum=4, cfg_patch={"remat": "save_mixer_ffn"},
                 opt_sharding="zero1")
        best = min((it1, it2, it3), key=lambda r: r["roofline_step_s"])
        go("paper: fixed-codebook wire compression",
           f"remaining wire × {RATIO_PAPER} (measured)",
           compress=(RATIO_PAPER, "paper-interleaved"), base_rec=best)
        go("beyond-paper: plane-split codebooks",
           f"plane-split ratio {RATIO_PLANE_SPLIT}",
           compress=(RATIO_PLANE_SPLIT, "plane-split"), base_rec=best)

    elif arch == "mamba2-780m":
        base = go("baseline(chunk=128)",
                  "SSD intra-chunk term ∝ chunk Q per token: Q=128 "
                  "spends 2·Q·(N+P)=~66k extra FLOPs/token vs 6·N_p=4.7M "
                  "useful — check which term dominates")
        it1 = go("chunk=64",
                 "halving Q halves the intra-chunk quadratic FLOPs and "
                 "the (B,H,C,Q,Q) decay-tensor bytes; doubles (cheap) "
                 "inter-chunk scan steps → memory term −, compute −",
                 cfg_patch={"ssm_chunk": 64})
        it2 = go("chunk=256",
                 "doubling Q: opposite direction (control arm)",
                 cfg_patch={"ssm_chunk": 256})
        it3 = go("dp_only",
                 "780M params on 256 chips doesn't need TP: replicate "
                 "params, shard batch over all 256 → the per-layer TP "
                 "activation ARs vanish; wire = one grads AR "
                 "(~1.5 GB × 2(n-1)/n ≈ 3 GB ≈ 0.06 s vs 1.53 s)",
                 param_sharding="dp_only")
        best = min((base, it1, it2, it3), key=lambda r: r["roofline_step_s"])
        go("paper: fixed-codebook wire compression",
           f"DP gradient all-reduce × {RATIO_PAPER} (measured)",
           compress=(RATIO_PAPER, "paper-interleaved"), base_rec=best)
        go("beyond-paper: plane-split codebooks",
           f"plane-split ratio {RATIO_PLANE_SPLIT}",
           compress=(RATIO_PLANE_SPLIT, "plane-split"), base_rec=best)


CACHED = "[reused from"


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """Plan the pairs (``--pair`` a substring filter) into ``--out`` and
    return every record it holds.  A pair that ``--out`` already holds
    whole is not planned again: its records are reused, said so on
    stdout and in each record's ``note`` (delete ``--out`` to plan every
    pair anew after a change to the planner)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", default=None,
                    help="substring filter, e.g. 'qwen3'")
    ap.add_argument("--out", default="results/hillclimb.json")
    args = ap.parse_args(argv)

    records: List[Dict[str, Any]] = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)

    def flush():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1, default=str)

    for pair in PAIRS:
        if args.pair and args.pair not in pair:
            continue
        n_have = sum(1 for r in records if r["pair"] == pair)
        if n_have >= 5:
            print(f"[hillclimb] {pair}: {n_have} cached records, skipping "
                  f"(reused from {args.out})")
            for r in records:
                if r["pair"] == pair and not r["note"].startswith(CACHED):
                    r["note"] = f"{CACHED} {args.out}] {r['note']}"
            continue
        records[:] = [r for r in records if r["pair"] != pair]
        run_pair(pair, records, flush=flush)
        flush()
    print(f"\n[hillclimb] {len(records)} records → {args.out}")
    return records


if __name__ == "__main__":
    main()
