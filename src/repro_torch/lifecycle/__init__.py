"""Codebook lifecycle subsystem (port of ``repro.lifecycle``): drift
monitoring, epoch-versioned registries, synchronized hot-refresh off the
critical path.

  * ``monitor``  — online drift measurement per ``CodebookKey`` (KL vs
    the book's source PMF, excess coded bits vs per-batch Shannon);
  * ``manager``  — ``BookLifecycleManager``: epoch-versioned registry
    snapshots, EMA feeding, monitored rebuilds, the epoch-keyed
    built-step cache, manifest save/load;
  * ``sync``     — cross-rank (epoch, content-hash) agreement over a
    ``comm.axis`` axis; any divergence is a hard ``EpochSyncError``.
"""
from .manager import BookLifecycleManager
from .monitor import DriftMonitor, DriftReport, DriftThresholds
from .sync import (EpochSyncError, epoch_agreement, epoch_fingerprint,
                   verify_epoch_agreement)

__all__ = [
    "BookLifecycleManager",
    "DriftMonitor",
    "DriftReport",
    "DriftThresholds",
    "EpochSyncError",
    "epoch_agreement",
    "epoch_fingerprint",
    "verify_epoch_agreement",
]
