"""Production mesh shapes and the H100's roofline constants (port of
``repro.launch.mesh``).

``make_production_mesh`` is a function returning a shape-only mesh, so
importing this module touches no device: a single pod is (data=16,
model=16), 256 devices; multi-pod is (pod=2, data=16, model=16), 512
devices, with ``pod`` a second, outer data-parallel axis.  The axis
names and sizes are the reference's, so the port's plan of a
combination sits beside the reference's record by record.
``device_mesh`` turns a shape into a ``torch.distributed`` device mesh
inside a process group of exactly that many ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from ..models.common import Axes

__all__ = ["MeshShape", "make_production_mesh", "device_mesh", "axes_for",
           "HardwareSpec", "axis_span", "H100_SXM"]


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def name(self) -> str:
        """"16x16" or "2x16x16", the reference's record names."""
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def device_mesh(mesh: MeshShape, device_type: str = "cuda"):
    """The ``torch.distributed`` ``DeviceMesh`` of ``mesh``: only inside
    an initialised process group whose world size is the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"device_mesh({mesh.name}) needs an initialised "
                           f"process group of {mesh.size} ranks")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"mesh {mesh.name} has {mesh.size} devices, the "
                         f"process group {world} ranks")
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)


def axes_for(mesh) -> Axes:
    names = mesh.axis_names
    return Axes(data="data", model="model",
                model_size=mesh.shape["model"],
                extra_data=("pod",) if "pod" in names else ())


@dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants of one device.  ``link_bw`` is the link inside
    a node of ``node_size`` devices, ``inter_node_bw`` a device's share
    of the network between nodes: a collective whose group spans more
    than one node runs at the slower rate."""
    name: str
    peak_flops: float     # FLOP/s, bf16 dense
    hbm_bw: float         # bytes/s
    link_bw: float        # bytes/s a device, one direction, inside a node
    hbm_bytes: float      # device memory
    inter_node_bw: float  # bytes/s a device, one direction, across nodes
    node_size: int        # devices joined by ``link_bw``

    def group_bw(self, span: int) -> float:
        """The link rate of a collective whose group spans ``span``
        consecutive devices of the mesh (see ``axis_span``)."""
        return self.link_bw if span <= self.node_size else self.inter_node_bw


def axis_span(sizes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    """Consecutive devices a group over ``axes`` reaches: devices are
    numbered row-major over the mesh (its last axis fastest), so the
    group of its outermost axis ``a`` covers ``a``'s size times every
    axis after it."""
    names = list(sizes)
    first = min(names.index(a) for a in axes)
    span = 1
    for name in names[first:]:
        span *= sizes[name]
    return span


# NVIDIA H100 SXM5 80GB HBM3 (700 W), data sheet: 989 TFLOP/s dense bf16
# on the tensor cores, 3.35 TB/s of HBM3, NVLink 4 at 900 GB/s a GPU
# both ways (450 GB/s each way) among the 8 GPUs of an HGX H100 node,
# 80 GB.  Between nodes, the HGX H100 reference design gives each GPU
# one ConnectX-7 NDR InfiniBand port: 400 Gb/s, 50 GB/s each way.  A
# 16-wide axis, and every axis of the 16 x 16 and 2 x 16 x 16 meshes,
# spans more than one node.
H100_SXM = HardwareSpec("h100-sxm-80gb", peak_flops=989e12, hbm_bw=3.35e12,
                        link_bw=450e9, hbm_bytes=80e9, inter_node_bw=50e9,
                        node_size=8)
