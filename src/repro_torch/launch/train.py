"""Training launcher (port of ``repro.launch.train``): a pretrain loop on
``SyntheticDataset`` with the single-stage Huffman gradient probe and
the codebook lifecycle (bootstrap books → observe → drift → refresh).

    python -m repro_torch.launch.train --arch gemma2-2b --steps 8 \\
        --compress --refresh-every 2               # full width, on CUDA
    python -m repro_torch.launch.train --reduced --steps 3 --compress \\
        --refresh-every 1 --device cpu             # the smoke variant

Each step observes the gradient's per-plane histograms (kernel B5 on
the card) into the lifecycle manager; every ``--refresh-every`` steps
the drift monitor decides whether the stale books rebuild, and an epoch
flip releases the superseded step and swaps in a step bound to the new
books (``compiled``).  On CUDA the step is a ``train.CapturedTrainStep``
(the reference jits it): each epoch's first step runs eagerly and
captures a CUDA graph, which every later step of the epoch replays; on
the CPU it is the plain step.  The loop's observe, refresh, ledger and
one metrics copy a step run outside the graph, as outside the
reference's jit.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from ..capture import release
from ..checkpoint import save_pytree
from ..comm.compression import histogram256
from ..comm.ledger import CollectiveLedger
from ..configs import ARCH_IDS, get_config, train_grad_accum
from ..core.symbols import bf16_planes
from ..data import DataConfig, SyntheticDataset
from ..device import metrics_to_host, resolve_device
from ..lifecycle import BookLifecycleManager, DriftThresholds
from ..models.common import ModelConfig, tree_leaves
from ..models.transformer import model_init, param_count
from ..optim.adamw import AdamWConfig, cosine_schedule
from ..train.step import CapturedTrainStep, make_train_step, train_state_init

__all__ = ["bootstrap_codebooks", "train", "main"]


def bootstrap_codebooks(state, lifecycle: BookLifecycleManager,
                        tensor_kind: str = "grad") -> None:
    """Paper §4: codebooks come from PREVIOUS data — here, from the
    initial parameter distribution as the step-0 stand-in: the first
    65 536 elements of each of the first 8 leaves in the reference's
    leaf order (``tree_leaves``: dict keys sorted), as bf16, counted by
    B5 on the card.  The loop then re-observes real gradients and the
    manager rebuilds when the drift monitor flags staleness."""
    sample = torch.cat([leaf.detach().reshape(-1)[:65536].to(torch.float32)
                        for leaf in tree_leaves(state.params)[:8]])
    for plane, sym in bf16_planes(sample).items():
        lifecycle.install((tensor_kind, "bf16", plane),
                          histogram256(sym).cpu().numpy())


def _device_memory(dev: torch.device) -> Dict[str, int]:
    """The caching allocator's allocated and reserved bytes on a CUDA
    device (nothing on another)."""
    if dev.type != "cuda":
        return {}
    return {"memory_allocated": torch.cuda.memory_allocated(dev),
            "memory_reserved": torch.cuda.memory_reserved(dev)}


def train(cfg: ModelConfig, *, steps: int = 20, batch_size: int = 8,
          seq_len: int = 128, lr: float = 1e-3, grad_accum: int = 1,
          compress: bool = False, refresh_every: int = 10, seed: int = 0,
          device=None, params=None) -> Dict[str, Any]:
    """Run ``steps`` train steps of ``cfg`` (params from ``seed`` unless
    given; they are not modified) and return the run's record: the
    final ``state``, the ``lifecycle`` manager, the ``ledger``, one host
    dict a step (``steps``: scalar metrics and ``step_seconds``, the
    host clock around the step and its one metrics copy), the epoch
    flips (``refreshes``: step, epoch, the refresh's host seconds and,
    on CUDA, ``memory_allocated`` / ``memory_reserved`` bytes once the
    superseded step is released) and the bootstrap ``spec``.  Every
    step is released by the end of the run."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model_init(cfg, gen, device=dev)
    print(f"[train] params: {param_count(params):,}")
    state = train_state_init(params)
    del params
    lifecycle = BookLifecycleManager(
        thresholds=DriftThresholds(min_symbols=1024))
    if compress:
        bootstrap_codebooks(state, lifecycle)
    sched = cosine_schedule(lr, warmup=max(steps // 20, 1), total=steps)

    def build_step(mgr):
        spec = (mgr.spec("grad", "bf16", mode="ledger") if compress
                else None)
        step = make_train_step(cfg, AdamWConfig(lr=lr), sched,
                               grad_accum=grad_accum, comp_spec=spec)
        return CapturedTrainStep(step) if dev.type == "cuda" else step

    boot_spec = lifecycle.spec("grad", "bf16") if compress else None
    step_fn = lifecycle.compiled("train_step", build_step)
    ds = iter(SyntheticDataset(cfg, DataConfig(batch_size, seq_len,
                                               seed=seed)))
    ledger = CollectiveLedger()
    rec: Dict[str, Any] = {"steps": [], "refreshes": []}
    t_all = time.perf_counter()
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(ds).items()}
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        host = metrics_to_host(m)               # the step's one sync
        row = {k: v for k, v in host.items() if isinstance(v, float)}
        row["step_seconds"] = time.perf_counter() - t0
        rec["steps"].append(row)
        if compress:
            # DP all-reduce of grads: the ledger keys stay meaningful
            # with one replica (ring factor 2(n-1)/n at n = 1 is 0).
            ledger.record("grad/all_reduce(dp)", {
                "raw_wire_bits": host["grad_raw_bits"],
                "coded_wire_bits": host["grad_coded_bits"]})
            reports = lifecycle.observe_train_metrics(host)
            if refresh_every > 0 and (i + 1) % refresh_every == 0:
                t0 = time.perf_counter()
                new_epoch = lifecycle.maybe_refresh()
                refresh_s = time.perf_counter() - t0
                if new_epoch is not None:
                    release(step_fn)        # before the new one warms up
                    step_fn = lifecycle.compiled("train_step", build_step)
                    worst = max(reports.values(),
                                key=lambda r: r.excess_bits)
                    rec["refreshes"].append({
                        "step": i, "epoch": new_epoch, "seconds": refresh_s,
                        "kl_bits": worst.kl_bits,
                        "excess_bits": worst.excess_bits,
                        **_device_memory(dev)})
                    print(f"[train] step {i}: stale books rebuilt → epoch "
                        f"{new_epoch} (kl={worst.kl_bits:.3f} "
                        f"excess={worst.excess_bits:.3f} bits/sym); "
                        f"recompiles={lifecycle.n_recompiles}")
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            print(f"[train] step {i:>4} loss={row['loss']:.4f} "
                f"ce={row['ce']:.4f} gnorm={row['grad_norm']:.3f}")
    release(step_fn)
    rec.update(state=state, lifecycle=lifecycle, ledger=ledger,
               spec=boot_spec, seconds=time.perf_counter() - t_all)
    return rec


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--compress", action="store_true",
                    help="enable the fixed-codebook gradient probe")
    ap.add_argument("--refresh-every", "--rebuild-every", type=int,
                    default=10, dest="refresh_every",
                    help="steps between lifecycle refresh checks (the "
                         "drift monitor decides whether books rebuild)")
    ap.add_argument("--save-books", default=None,
                    help="directory for the epoch manifest + registry "
                         "blob at the end of the run")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    ga = args.grad_accum or (1 if args.reduced
                             else train_grad_accum(args.arch))
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} "
          f"d_model={cfg.d_model} grad_accum={ga}")
    rec = train(cfg, steps=args.steps, batch_size=args.batch_size,
                seq_len=args.seq_len, lr=args.lr, grad_accum=ga,
                compress=args.compress, refresh_every=args.refresh_every,
                seed=args.seed, device=args.device)
    dt = rec["seconds"]
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s)")
    lifecycle = rec["lifecycle"]
    if args.compress:
        print(f"[train] lifecycle: epoch={lifecycle.book_epoch} "
              f"refreshes={lifecycle.n_refreshes} "
              f"recompiles={lifecycle.n_recompiles}")
        print("[train] collective-compression ledger:")
        print(rec["ledger"].report())
        if args.save_books:
            path = lifecycle.save(args.save_books)
            print(f"[train] epoch manifest → {path}")
    if args.checkpoint:
        save_pytree(args.checkpoint, rec["state"].params,
                    {"arch": cfg.name, "steps": args.steps})
        print(f"[train] checkpoint → {args.checkpoint}")
    return rec


if __name__ == "__main__":
    main()
