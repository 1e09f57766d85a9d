"""The comparison of served tokens and logits with the reference.

For each checked request the reference runs once over its prompt (and
prefix) followed by the tokens it was served, and reads at every served
position the gap by which the served token's logit lies below the
reference's best: 0 where the reference picks the same token, small
where a near-tie flipped on the served model's rounding.  Where the
served model's logits of a request were kept, it also reads each decode
step's relative logit error against its own.  The numbers are the
widest gap and the widest logit error (and its 99.9th and 99th
percentiles) over every request and step read, so a fault confined to
a few steps or rows shows.  The control is
the same reference in a lower precision (``common.Precision("fp8")``)
put in the server's place: at each position it "serves" its own best
token, whose gap under the float32 reference is read, and its logits'
error is read alike.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .common import Precision, exact_float32


def _gaps(ref: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    best = ref.max(dim=-1).values
    return best - ref.gather(-1, picked[..., None])[..., 0]


def _err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """‖got − ref‖ / ‖ref‖ over the last axis, every position."""
    d = torch.linalg.vector_norm(got.to(torch.float32) - ref, dim=-1)
    return (d / torch.linalg.vector_norm(ref, dim=-1)).reshape(-1).cpu()


def served_gaps(model, params, m: Dict, requests: Sequence[Dict],
                control: Optional[str] = None, block: int = 32
                ) -> Dict[str, np.ndarray]:
    """``requests``: dicts of ``prompt`` (S,) int64, ``served`` (N,)
    int64, an optional ``prefix`` (P, d) and optional ``logits`` (N − 1,
    V), the served model's logits of its decode steps, on the device;
    one prompt length for all, run ``block`` at a time.  Returns every
    served token's gap (``served``), each decode step's relative logit
    error ‖served − reference‖ / ‖reference‖ over the vocabulary
    (``served_err``), and with ``control`` the gap of each token the
    control picks at the same positions (``control``) and its logits'
    error at the positions of the requests with logits
    (``control_err``)."""
    out: Dict[str, List[np.ndarray]] = {"served": [], "control": [],
                                        "served_err": [],
                                        "control_err": []}
    start = int(requests[0]["prompt"].shape[0]) - 1
    with exact_float32():
        for lo in range(0, len(requests), block):
            part = requests[lo:lo + block]
            served = torch.stack([r["served"] for r in part])
            seq = torch.cat([torch.stack([r["prompt"] for r in part]),
                             served[:, :-1]], dim=1)
            prefix = (torch.stack([r["prefix"] for r in part])
                      if part[0].get("prefix") is not None else None)
            ref = model.logits(params, seq, m, start, prefix=prefix)
            out["served"].append(_gaps(ref, served).reshape(-1).cpu())
            rows = [i for i, r in enumerate(part)
                    if r.get("logits") is not None]
            if rows:
                got = torch.stack([part[i]["logits"] for i in rows])
                out["served_err"].append(_err(got, ref[rows, 1:]))
            if control:
                low = model.logits(params, seq, m, start, prefix=prefix,
                                   prec=Precision(control))
                out["control"].append(_gaps(ref, low.argmax(
                    dim=-1)).reshape(-1).cpu())
                if rows:
                    out["control_err"].append(_err(low[rows, 1:],
                                                   ref[rows, 1:]))
                del low
            del ref
    return {k: torch.cat(v).numpy() for k, v in out.items() if v}


def gap_numbers(out: Dict[str, np.ndarray], side: str = "served"
                ) -> Dict[str, float]:
    """The widest gap, and the widest relative logit error with its
    99.9th and 99th percentiles, of ``side`` (``served`` or
    ``control``), under the served model's names.  A cell's file names
    which of them are judged."""
    numbers = {"served_gap_max": float(out[side].max())}
    if f"{side}_err" in out:
        err = out[f"{side}_err"]
        numbers["served_logit_err_max"] = float(err.max())
        numbers["served_logit_err_p999"] = float(np.quantile(err, 0.999))
        numbers["served_logit_err_p99"] = float(np.quantile(err, 0.99))
    return numbers


def pick_requests(call: int, batch: int, count: int, seed: int
                  ) -> List[tuple]:
    """``count`` (call, row) pairs drawn from the seed: rows of
    ``call`` (itself drawn from the seed, the call whose logits were
    kept)."""
    rng = np.random.default_rng((seed * 7919 + 17) % (1 << 63))
    rows = rng.choice(batch, size=min(count, batch), replace=False)
    return [(call, int(r)) for r in rows]
