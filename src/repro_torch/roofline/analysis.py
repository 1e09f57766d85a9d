"""Roofline terms of one (arch × shape × mesh) plan (port of
``repro.roofline.analysis``).

Three terms a device, in seconds:

    compute    = FLOPs / peak FLOP/s
    memory     = HBM bytes / HBM bandwidth
    collective = Σ wire bytes / the link bandwidth of each collective

The FLOPs and bytes are ``roofline.analytic``'s closed forms and the
wire bytes and seconds ``roofline.collectives``' schedule over the
partition specs, each collective on NVLink inside a node or on the
network across nodes: the port's own counts, where the reference reads
XLA's ``cost_analysis``, ``memory_analysis`` and partitioned HLO and
divides all wire bytes by one link rate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .collectives import CollectiveStats

__all__ = ["RooflineReport", "roofline_report", "model_flops"]


def model_flops(n_params_active: int, n_tokens: int, train: bool) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward."""
    return (6.0 if train else 2.0) * n_params_active * n_tokens


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    wire_bytes: float              # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_total: float
    useful_flops_ratio: float
    bytes_per_device: Dict[str, float]
    collectives: Dict
    note: str = ""

    def to_dict(self) -> Dict:
        return dict(self.__dict__)


def roofline_report(*, arch: str, shape: str, mesh_name: str,
                    n_devices: int, terms: Dict[str, float],
                    coll: CollectiveStats, model_flops_total: float,
                    bytes_per_device: Dict[str, float], note: str = ""
                    ) -> RooflineReport:
    """``terms`` is ``analytic_terms``' dict (per device)."""
    compute_s = terms["analytic_compute_s"]
    memory_s = terms["analytic_memory_s"]
    wire = coll.total_wire_bytes
    collective_s = coll.seconds
    by = {"compute": compute_s, "memory": memory_s,
          "collective": collective_s}
    total = terms["analytic_flops"] * n_devices
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, wire_bytes=wire,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(by, key=by.get), model_flops_total=model_flops_total,
        useful_flops_ratio=model_flops_total / total if total else 0.0,
        bytes_per_device=bytes_per_device, collectives=coll.to_dict(),
        note=note)
