"""End-to-end example (port of the reference's
``examples/train_sft_compressed.py``): SFT a ~100M-parameter
Gemma-family model with the single-stage compression feature live:

  * gradients are probed every step against the fixed codebook (the
    exact coded size of the DP all-reduce payload: kernel B5's
    histograms · the books' lengths),
  * gradient PMFs are observed and the books rebuilt off the critical
    path every ``--rebuild-every`` steps (the paper's §4 lifecycle),
  * the collective ledger reports raw vs coded wire traffic at the end.

On CUDA the step is a ``train.CapturedTrainStep`` (the reference jits
it): captured as a CUDA graph at its first call after each rebuild and
replayed for every later step; a rebuild releases the superseded one.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_sft_compressed \\
          [--steps 300] [--d-model 768] [--layers 12] [--device cpu]
(defaults give ~100M params; reduce for a quicker demo)
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from ..capture import release
from ..comm import CollectiveLedger, CompressionSpec, histogram256
from ..core.codebook import CodebookRegistry
from ..core.symbols import bf16_planes, xla_cast
from ..data import DataConfig, SyntheticDataset
from ..device import metrics_to_host, resolve_device
from ..models import BlockGroup, ModelConfig, model_init, param_count
from ..models.common import tree_leaves
from ..optim import AdamWConfig, cosine_schedule
from ..train import CapturedTrainStep, make_train_step, train_state_init

__all__ = ["main"]


def sft_config(d_model: int, layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        name="gemma-sft-100m", arch_type="dense", d_model=d_model,
        vocab_size=vocab, blocks=(BlockGroup(("attn",), layers),),
        n_heads=d_model // 64, n_kv_heads=max(d_model // 256, 1),
        head_dim=64, d_ff=4 * d_model, ffn_activation="gelu",
        tie_embeddings=True, remat="block")


def main(argv: Optional[list] = None, *, device=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=32_768)
    ap.add_argument("--rebuild-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)

    cfg = sft_config(args.d_model, args.layers, args.vocab)
    params = model_init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_params = param_count(params)
    print(f"[sft] {cfg.name}: {n_params:,} params, {cfg.n_layers} layers")
    state = train_state_init(params)
    del params

    # Bootstrap codebooks from the initial parameter byte statistics;
    # the loop replaces them with real gradient PMFs within one rebuild.
    registry = CodebookRegistry()
    seed_vals = torch.cat([l.reshape(-1)[:65536].to(torch.float32)
                           for l in tree_leaves(state.params)[:8]])
    for plane, sym in bf16_planes(xla_cast(seed_vals,
                                           torch.bfloat16)).items():
        registry.install(("grad", "bf16", plane),
                         histogram256(sym).cpu().numpy())
    spec = CompressionSpec.from_registry(registry, "grad", "bf16", "ledger")

    sched = cosine_schedule(3e-4, warmup=20, total=args.steps)
    opt = AdamWConfig(lr=3e-4)

    def build_step(s):
        step = make_train_step(cfg, opt, sched, comp_spec=s)
        return CapturedTrainStep(step) if dev.type == "cuda" else step

    step = build_step(spec)
    ds = iter(SyntheticDataset(cfg, DataConfig(args.batch_size,
                                               args.seq_len)))
    ledger = CollectiveLedger()
    rows, rebuilds = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(ds).items()}
        state, m = step(state, batch)
        host = metrics_to_host(m)               # the step's one sync
        rows.append({"loss": host["loss"], "grad_norm": host["grad_norm"],
                     "grad_raw_bits": host["grad_raw_bits"],
                     "grad_coded_bits": host["grad_coded_bits"]})
        ledger.record("grad/all_reduce(dp)", {
            "raw_wire_bits": host["grad_raw_bits"],
            "coded_wire_bits": host["grad_coded_bits"]})
        for plane in ("lo", "hi"):
            registry.observe(("grad", "bf16", plane),
                             host[f"grad_hist_{plane}"])
        if (i + 1) % args.rebuild_every == 0:
            registry.rebuild()
            spec = CompressionSpec.from_registry(registry, "grad", "bf16",
                                                 "ledger")
            release(step)               # before the new one warms up
            step = build_step(spec)
            rebuilds.append(i)
            print(f"[sft] step {i}: codebooks rebuilt "
                  f"(ratio so far {ledger.overall_ratio():.3f})")
        if i % 25 == 0 or i == args.steps - 1:
            saved = 1 - host["grad_coded_bits"] / max(host["grad_raw_bits"],
                                                      1)
            print(f"[sft] step {i:>4} loss={host['loss']:.4f} "
                  f"gnorm={host['grad_norm']:.2f} saved={100 * saved:.1f}%")
    release(step)
    dt = time.time() - t0
    print(f"\n[sft] {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s)")
    print(ledger.report())
    ratios = [r["grad_coded_bits"] / r["grad_raw_bits"] for r in rows]
    return {"params": n_params, "steps": args.steps, "seconds": dt,
            "losses": [r["loss"] for r in rows],
            "coded_over_raw": ratios, "rebuild_steps": rebuilds,
            "rebuilds": [{"step": i, "coded_over_raw_before": ratios[i],
                          "coded_over_raw_after": ratios[i + 1]}
                         for i in rebuilds if i + 1 < len(ratios)],
            "ledger_ratio": ledger.overall_ratio(),
            "ledger": ledger.summary()}


if __name__ == "__main__":
    main()
