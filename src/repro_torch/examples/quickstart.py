"""Quickstart: the single-stage Huffman encoder in five minutes (port of
the reference's ``examples/quickstart.py``).

1. Build a fixed codebook from "previous batch" statistics.
2. Encode a new tensor with it — one pass, no scan, no tree build,
   no codebook on the wire.
3. Decode and verify bit-exactness, and that the coded bits are the
   histogram (kernel B5 on the card) · the book's lengths.
4. Compare against the ideal (Shannon) bound and the per-message
   three-stage oracle.

The data are the reference's: ``numpy`` draws from seed 0, 2^18
"previous" values and 2^16 new ones, rounded to bfloat16 as the
reference rounds them (``core.symbols.bf16_planes_np``).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..comm.compression import histogram256
from ..core.codebook import CodebookRegistry
from ..core.encoder import (decode_with_book, single_stage_encode,
                            three_stage_encode)
from ..core.entropy import shannon_entropy
from ..core.symbols import bf16_planes_np
from ..device import resolve_device

__all__ = ["main"]


def main(argv: Optional[list] = None, *, device=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    rng = np.random.default_rng(0)

    # --- "previous batches": bf16 activations from earlier steps --------
    previous = rng.normal(size=1 << 18)
    registry = CodebookRegistry()
    for plane, sym in bf16_planes_np(previous).items():
        registry.install(("ffn1_act", "bf16", plane),
                         np.bincount(sym, minlength=256))
    print(f"registry holds {len(registry)} codebooks "
          f"(one per bf16 byte plane)")

    # --- a NEW batch arrives: single-stage encode ------------------------
    planes = bf16_planes_np(rng.normal(size=1 << 16))
    rec: Dict[str, Any] = {"registry_books": len(registry), "planes": {}}
    total_raw = total_coded = 0
    for plane, sym in planes.items():
        book = registry.get(("ffn1_act", "bf16", plane))
        sym_t = torch.from_numpy(sym).to(dev)
        res = single_stage_encode(sym_t, book, device=dev)
        decoded = decode_with_book(res.words, book, len(sym))
        lossless = bool(torch.equal(decoded.to(torch.uint8), sym_t))
        assert lossless, "lossless!"
        n_bits = int(res.n_bits)
        ledger = int((histogram256(sym_t).to(torch.int64) * torch.from_numpy(
            book.lengths.astype(np.int64)).to(dev)).sum())
        assert n_bits == ledger, "coded bits = histogram . lengths"
        h = float(shannon_entropy(np.bincount(sym, minlength=256)))
        print(f"plane {plane}: entropy {h:5.2f} bits  "
              f"coded {n_bits / len(sym):5.2f} bits/sym  (ideal {h:4.2f})")
        rec["planes"][plane] = {"symbols": len(sym), "entropy_bits": h,
                                "coded_bits": n_bits,
                                "histogram_dot_lengths": ledger,
                                "bits_per_symbol": n_bits / len(sym),
                                "lossless": lossless}
        total_raw += 8 * len(sym)
        total_coded += n_bits
    fixed = 1 - total_coded / total_raw

    # --- vs. the three-stage oracle on the same data ---------------------
    oracle_bits = 0
    for plane, sym in planes.items():
        res3, _, _ = three_stage_encode(sym, device=dev)
        rec["planes"][plane]["oracle_bits"] = int(res3.n_bits)
        oracle_bits += int(res3.n_bits)
    oracle = 1 - oracle_bits / total_raw

    print(f"\nfixed-codebook compressibility : {100 * fixed:5.2f} %")
    print(f"per-message Huffman (3-stage)  : {100 * oracle:5.2f} %")
    print(f"gap                            : {100 * (oracle - fixed):5.3f} % "
          f"(paper: < 0.5 %)")
    print("\nhardware-mode selection: pick the best book per message")
    bid, ebits = registry.select_best(np.bincount(planes["hi"],
                                                  minlength=256))
    print(f"  argmin book id={bid} ({registry.by_id(bid).key}) "
          f"→ {ebits:.2f} bits/sym")
    rec.update(raw_bits=total_raw, coded_bits=total_coded,
               oracle_bits=oracle_bits, fixed_compressibility=fixed,
               oracle_compressibility=oracle, gap=oracle - fixed,
               select_best={"book_id": bid,
                            "key": list(registry.by_id(bid).key),
                            "bits_per_symbol": ebits})
    return rec


if __name__ == "__main__":
    main()
