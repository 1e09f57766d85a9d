"""Serving with compressed collectives (port of the reference's
``examples/serve_compressed.py``): batched requests through a small
decoder, then the wire proven lossless through an all-gather that
carries the actual Huffman bitstream (bitexact mode) over 8 ranks, and
the same payload all-reduced over the coded ring.

The 8 ranks are a ``comm.LoopbackAxis`` (all ranks stacked on one
device, as the reference's 8 host devices under ``shard_map``); every
stat is summed over the ranks, as the reference ``psum``s it.  The
weights and the payloads are random from seeds 0–3.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_compressed [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..comm import (CompressionSpec, LoopbackAxis, all_gather_bitexact,
                    all_reduce_compressed, histogram256)
from ..core.codebook import build_codebook
from ..core.symbols import bf16_planes, xla_cast
from ..device import resolve_device
from ..models import BlockGroup, ModelConfig, model_init
from ..serve import Engine, ServeConfig

__all__ = ["main"]

RANKS = 8


def demo_config() -> ModelConfig:
    return ModelConfig(
        name="serve-demo", arch_type="dense", d_model=256, vocab_size=1024,
        blocks=(BlockGroup(("attn",), 4),), n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=512, remat="none")


def _bf16_normal(seed: int, shape, dev) -> torch.Tensor:
    """N(0, 1) drawn on the host from ``seed``, as bfloat16 on ``dev``."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    return xla_cast(x, torch.bfloat16).to(dev)


def main(argv: Optional[list] = None, *, device=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    cfg = demo_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model_init(cfg, gen, device=dev)

    # ---- batched generation --------------------------------------------
    engine = Engine(params, cfg, ServeConfig(max_cache_len=128,
                                             temperature=0.8), device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 16),
                            generator=torch.Generator().manual_seed(1))
    out, _ = engine.generate(prompts, max_new_tokens=24)
    print(f"[serve] generated {out.shape} tokens for 4 requests")
    print(f"[serve] first request: {out[0][:12]} ...")
    rec: Dict[str, Any] = {"generated_shape": list(out.shape),
                           "first_request": out[0].tolist()}

    # ---- the wire: hidden-state all-gather with the real bitstream ------
    # A TP all-gather of decode activations, coded with fixed books built
    # from a PREVIOUS batch (the paper's deployment).
    prev = _bf16_normal(2, (RANKS, 64, 256), dev)
    books = {p: build_codebook(histogram256(s).cpu().numpy(),
                               key=("act", "bf16", p))
             for p, s in bf16_planes(prev).items()}
    x = _bf16_normal(3, (RANKS, 64, 256), dev)
    axis = LoopbackAxis(RANKS, name="tp")
    y, stats = all_gather_bitexact(x[:, None], axis, books, "bf16")
    bitexact = all(torch.equal(y[r].view(torch.int16), x.view(torch.int16))
                   for r in range(RANKS))
    assert bitexact, "bit-exact through wire"
    raw = float(stats["payload_raw_bits"].sum())
    coded = float(stats["payload_coded_bits"].sum())
    # a rank's coded payload is every shard's stream: the histogram of
    # the whole tensor (kernel B5 on the card) . the books' lengths
    ledger = sum(int((histogram256(s).to(torch.int64) * torch.from_numpy(
        books[p].lengths.astype(np.int64)).to(dev)).sum())
        for p, s in bf16_planes(x).items())
    per_rank = stats["payload_coded_bits"]
    assert bool((per_rank == float(ledger)).all()), \
        "coded bits = histogram . lengths"
    print(f"[serve] all-gather wire: raw {raw / 8 / 1024:.1f} KiB → "
          f"coded {coded / 8 / 1024:.1f} KiB "
          f"({100 * (1 - coded / raw):.1f} % saved), bit-exact ✓")
    rec["gather"] = {"bitexact": bitexact, "raw_bits": raw,
                     "coded_bits": coded, "rank_coded_bits": ledger,
                     "histogram_dot_lengths": ledger}

    # ---- transport selection: the same payload over the ring ------------
    # spec.transport picks the wire strategy; the ring keeps the payload
    # coded on every hop and measures each hop's bits.
    spec = CompressionSpec.from_books(books, "bf16", mode="bitexact",
                                      transport="ring", chunk=1024,
                                      decode_backend="scan")
    yr, rs = all_reduce_compressed(x, axis, books, spec)
    hop = rs["hop_coded_bits"].sum(0).cpu().numpy() / 8.0 / 1024.0
    hops = int(float(rs["hops"].sum()))
    coded_w = float(rs["coded_wire_bits"].sum())
    raw_w = float(rs["raw_wire_bits"].sum())
    same = all(torch.equal(yr[r].view(torch.int16), yr[0].view(torch.int16))
               for r in range(RANKS))
    print(f"[serve] ring all-reduce: {hops} coded hops, "
          f"per-hop {hop.min():.1f}–{hop.max():.1f} KiB, "
          f"wire {coded_w / 8 / 1024:.1f} KiB coded vs "
          f"{raw_w / 8 / 1024:.1f} KiB raw")
    rec["ring"] = {"hops": hops, "hop_kib": hop.tolist(),
                   "coded_wire_bits": coded_w, "raw_wire_bits": raw_w,
                   "finite": bool(torch.isfinite(yr.float()).all()),
                   "ranks_agree": same}
    return rec


if __name__ == "__main__":
    main()
