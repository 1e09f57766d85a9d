"""Cross-device epoch agreement — all shards flip books together (port
of ``repro.lifecycle.sync``).

A fixed-book transport where peers hold different books does not fail:
it silently mis-decodes every ring hop (the canonical tables are pure
functions of the code lengths, so a one-bit lengths difference scrambles
whole chunks).  The agreement protocol therefore treats any divergence
as a **hard error**:

  1. each replica derives a 64-bit **fingerprint** from its lifecycle
     state: ``(book_epoch, registry-content-hash digest)``;
  2. at a step boundary the fingerprints ride one tiny ``all_gather``
     over the data-parallel axis (``comm.axis``: a ``LoopbackAxis`` on
     one card, a ``ProcessGroupAxis`` across processes; 8 bytes a rank);
  3. every rank compares the gathered table against its own entry; any
     mismatch raises ``EpochSyncError`` on the host before the next
     compressed collective can run.

Fingerprints are the reference's ``(2,)`` uint32 numpy pairs at the
host boundary; on the axis they ride as int64 tensors (CPU torch has no
uint32 comparison), which hold every uint32 value exactly.
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Union

import numpy as np
import torch

from ..core.codebook import CodebookRegistry, RegistrySnapshot
from ..device import resolve_device

__all__ = ["EpochSyncError", "epoch_fingerprint", "epoch_agreement",
           "verify_epoch_agreement", "A2A_WIRE_FINGERPRINT"]

# What the reference's ``models.moe.a2a_wire_fingerprint()`` returns in
# a process that never configured the MoE all-to-all wire.  The port has
# no MoE dispatch yet (ROADMAP.md A8), so every replica folds this
# constant, and fingerprints agree across the two packages.
A2A_WIRE_FINGERPRINT = "a2a:unconfigured"


class EpochSyncError(RuntimeError):
    """Replicas disagree on (book_epoch, registry content)."""


def epoch_fingerprint(state: Union[RegistrySnapshot, CodebookRegistry,
                                   "object"]) -> np.ndarray:
    """(2,) uint32 ``[epoch, content digest]`` for the wire.

    Accepts a ``RegistrySnapshot``, a ``CodebookRegistry`` or a
    ``BookLifecycleManager`` (anything exposing ``snapshot``).  The
    digest covers the registry content hash — which covers each book's
    codec identity — plus the MoE a2a wire term
    (``A2A_WIRE_FINGERPRINT``), exactly as the reference folds them.
    """
    snap = state
    if isinstance(state, CodebookRegistry):
        snap = state.snapshot()
    elif not isinstance(state, RegistrySnapshot):
        snap = getattr(state, "snapshot", None)
        snap = snap() if callable(snap) else snap
        if not isinstance(snap, RegistrySnapshot):
            raise TypeError(f"cannot fingerprint {type(state).__name__}")
    content = hashlib.sha256(
        (snap.content_hash + "\x1e" + A2A_WIRE_FINGERPRINT).encode())
    digest = int(content.hexdigest()[:8], 16)
    return np.array([snap.epoch & 0xFFFFFFFF, digest], dtype=np.uint32)


def epoch_agreement(fp: torch.Tensor, axis) -> torch.Tensor:
    """Agreement over ``axis`` (a ``comm.axis.Axis``).

    ``fp`` is each rank's fingerprint, int64 of shape ``axis.batch +
    (2,)``; returns, per rank (shape ``axis.batch``), the number of
    peers whose fingerprint differs from its own — 0 everywhere when all
    agree, positive on every rank when any diverges (the gather makes
    the check symmetric: every rank sees the mismatch, not just the odd
    one out).
    """
    gathered = axis.all_gather(fp)                 # batch + (n, 2)
    return (gathered != fp.unsqueeze(-2)).any(dim=-1).sum(dim=-1)


def verify_epoch_agreement(fingerprints: Union[np.ndarray, Sequence],
                           axis=None, *, device=None) -> None:
    """Host-level hard gate over per-rank fingerprints.

    Without ``axis``, ``fingerprints`` is (n, 2) uint32 — one
    ``epoch_fingerprint`` row per rank — compared on the host.  With an
    axis the check runs ``epoch_agreement`` over it (what a deployment
    runs at the flip boundary): on a ``LoopbackAxis`` of n ranks the
    rows are its ranks, (n, 2); on a ``ProcessGroupAxis`` this process
    passes its own row, (2,).  ``device`` is where the fingerprints
    ride: CUDA unless the caller passes ``device="cpu"`` (a loopback on
    the host, a gloo group); the host path takes no device.  Raises
    ``EpochSyncError`` on any disagreement, listing the distinct
    (epoch, digest) pairs.
    """
    fps = np.asarray(fingerprints, dtype=np.uint32)
    if fps.shape[-1] != 2 or fps.ndim not in (1, 2):
        raise ValueError(f"expected (n, 2) or (2,) fingerprints, got "
                         f"{fps.shape}")
    if axis is not None:
        if fps.shape[:-1] != tuple(axis.batch):
            raise ValueError(f"fingerprints {fps.shape} do not carry the "
                             f"axis's rank dims {tuple(axis.batch)}")
        t = torch.from_numpy(fps.astype(np.int64)).to(resolve_device(device))
        mismatches = int(epoch_agreement(t, axis).max())
        if mismatches:              # every rank sees it, so all gather
            fps = axis.all_gather(t).reshape(-1, 2).cpu().numpy()
    else:
        if fps.ndim != 2:
            raise ValueError(f"expected (n, 2) fingerprints, got "
                             f"{fps.shape}")
        mismatches = int((fps != fps[0]).any(axis=-1).sum())
    if mismatches:
        pairs = sorted({(int(e), int(d)) for e, d in fps})
        raise EpochSyncError(
            f"replicas disagree on codebook epoch/content: {mismatches} "
            f"mismatching peers; distinct (epoch, digest32) = "
            f"{[(e, hex(d)) for e, d in pairs]} — a mixed-book fleet "
            f"would silently corrupt every compressed hop, refusing to "
            f"proceed")
