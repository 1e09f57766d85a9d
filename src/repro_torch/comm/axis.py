"""The port's mesh axis: what the reference's ``axis_name`` stands for.

The reference's collectives run as ``shard_map`` bodies over a named
mesh axis and call four ``jax.lax`` collectives on it (``ppermute``,
``psum``, ``all_gather``, ``axis_index``) plus ``axis_size``.  Here an
``Axis`` object carries the same (``size``, ``index``, ``ppermute`` by a
shift, ``psum``, ``all_gather``, and ``permute`` for any pairs), with
two implementations written to one interface, so the ring code exists
once:

  LoopbackAxis      all ranks in one process on one device.  Every
      per-rank tensor carries the leading rank dims ``batch`` — (n,) for
      one axis, (n_outer, n_inner) for a two-axis mesh — exactly the
      shapes ``jax.vmap(f, axis_name=...)`` gives the reference's bodies.
      ``ppermute`` by a shift is a roll along the axis's dim, ``psum``
      sums over it and broadcasts the sum back, ``index`` is an arange.
      A function called on the stacked tensors runs every rank's body at
      once (the role ``shard_map`` plays), so a ring hop's encode and
      decode are one kernel launch for all ranks.  This is how a ring
      runs on one card: NCCL puts no two ranks on one device.
  ProcessGroupAxis  one rank a process, through ``torch.distributed``
      (``batch_isend_irecv``, ``all_reduce``, ``all_gather``); its
      tensors carry no rank dims (``batch == ()``).

``take_rows`` / ``put_rows`` are the per-rank indexing the ring needs
(``jnp.take`` / ``.at[i].set`` with an index that differs by rank).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple, Union

import torch

from .wire import _BITS, rank_sum

__all__ = ["Axis", "LoopbackAxis", "ProcessGroupAxis", "loopback_mesh",
           "process_group_mesh", "take_rows", "put_rows"]

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


class Axis:
    """One mesh axis: its name and size, the leading rank dims every
    per-rank tensor carries, and the collectives over it."""

    name: str = "ring"
    size: int = 1
    batch: Tuple[int, ...] = ()

    def index(self, device) -> torch.Tensor:
        """Each rank's position on this axis: int64, shape ``batch``."""
        raise NotImplementedError

    def ppermute(self, tensors: Tensors, shift: int) -> Tensors:
        """Every rank sends its tensors to the rank ``shift`` places on
        (``i → (i + shift) % size``) and returns what it received."""
        raise NotImplementedError

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis, on every rank (bf16 and e4m3 added in
        rank order, ``wire.rank_sum``, as ``jax.lax.psum`` adds them)."""
        raise NotImplementedError

    def permute(self, t: torch.Tensor, perm) -> torch.Tensor:
        """``jax.lax.ppermute`` with any (source, destination) pairs: a
        rank that receives nothing gets zeros."""
        raise NotImplementedError

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """batch + s → batch + (size,) + s: every rank's tensor, in rank
        order, on every rank (``jax.lax.all_gather``, untiled)."""
        raise NotImplementedError


class LoopbackAxis(Axis):
    """All ranks of the axis in one process: ``dim`` of the leading rank
    dims ``batch`` (default ``(size,)``) runs along it."""

    def __init__(self, size: int, *, name: str = "ring",
                 batch: Tuple[int, ...] = None, dim: int = 0):
        self.size = int(size)
        self.name = name
        self.batch = (self.size,) if batch is None else tuple(batch)
        self.dim = dim
        if self.batch[dim] != self.size:
            raise ValueError(f"batch {self.batch} has {self.batch[dim]} "
                             f"ranks at dim {dim}, not {self.size}")

    def index(self, device) -> torch.Tensor:
        shape = [1] * len(self.batch)
        shape[self.dim] = self.size
        return torch.arange(self.size, device=device).reshape(
            shape).expand(self.batch)

    def ppermute(self, tensors: Tensors, shift: int) -> Tensors:
        if isinstance(tensors, torch.Tensor):
            return torch.roll(tensors, shifts=shift, dims=self.dim)
        return tuple(torch.roll(t, shifts=shift, dims=self.dim)
                     for t in tensors)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return rank_sum(t, self.dim).unsqueeze(self.dim).expand_as(t)

    def permute(self, t: torch.Tensor, perm) -> torch.Tensor:
        if t.dtype in _BITS:                        # torch moves no fp8
            return self.permute(t.view(_BITS[t.dtype]), perm).view(t.dtype)
        src = {d: s for s, d in perm}
        idx = torch.tensor([src.get(d, 0) for d in range(self.size)],
                           device=t.device)
        keep = torch.tensor([d in src for d in range(self.size)],
                            device=t.device)
        shape = [1] * t.dim()
        shape[self.dim] = self.size
        out = t.index_select(self.dim, idx)
        return torch.where(keep.reshape(shape), out, torch.zeros_like(out))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        nl = len(self.batch)
        g = t.movedim(self.dim, nl - 1).unsqueeze(self.dim)
        return g.expand(*self.batch, *g.shape[nl:])


def loopback_mesh(sizes: Mapping[str, int]) -> Dict[str, LoopbackAxis]:
    """Named loopback axes over one stack of ranks: ``{"outer": 2,
    "inner": 4}`` gives tensors the leading dims (2, 4), axis ``outer``
    on dim 0 and ``inner`` on dim 1."""
    batch = tuple(int(v) for v in sizes.values())
    return {name: LoopbackAxis(n, name=name, batch=batch, dim=d)
            for d, (name, n) in enumerate(sizes.items())}


def process_group_mesh(device_mesh) -> Dict[str, "ProcessGroupAxis"]:
    """Named process-group axes of a ``torch.distributed`` ``DeviceMesh``
    (``launch.mesh.device_mesh`` builds one inside a process group): the
    axis ``name`` is the group of the ranks that differ from this one
    only along that mesh dim, as ``loopback_mesh`` names the dims of one
    stack of ranks."""
    return {name: ProcessGroupAxis(device_mesh.get_group(name), name=name)
            for name in device_mesh.mesh_dim_names}


class ProcessGroupAxis(Axis):
    """One rank a process over a ``torch.distributed`` group (the
    default group when ``group`` is None)."""

    batch = ()

    def __init__(self, group=None, *, name: str = "ring"):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.name = name
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _global(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def index(self, device) -> torch.Tensor:
        return torch.tensor(self.rank, dtype=torch.int64, device=device)

    def ppermute(self, tensors: Tensors, shift: int) -> Tensors:
        dist = self._dist
        one = isinstance(tensors, torch.Tensor)
        sent = [tensors.contiguous()] if one else [t.contiguous()
                                                   for t in tensors]
        got = [torch.empty_like(t) for t in sent]
        dst = self._global((self.rank + shift) % self.size)
        src = self._global((self.rank - shift) % self.size)
        ops = []
        for s, g in zip(sent, got):
            ops.append(dist.P2POp(dist.isend, s, dst, self.group))
            ops.append(dist.P2POp(dist.irecv, g, src, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got[0] if one else tuple(got)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            return rank_sum(self.all_gather(t), 0)
        out = t.clone()
        self._dist.all_reduce(out, group=self.group)
        return out

    def permute(self, t: torch.Tensor, perm) -> torch.Tensor:
        dist = self._dist
        t = t.contiguous()
        out = torch.zeros_like(t)
        ops = [dist.P2POp(dist.isend, t, self._global(d), self.group)
               for s, d in perm if s == self.rank]
        ops += [dist.P2POp(dist.irecv, out, self._global(s), self.group)
                for s, d in perm if d == self.rank]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        self._dist.all_gather(list(out.unbind(0)), t, group=self.group)
        return out


def _rows(t: torch.Tensor, nl: int) -> Tuple[int, Tuple[int, ...]]:
    r = math.prod(t.shape[:nl])
    return r, tuple(t.shape[nl:])


def take_rows(t: torch.Tensor, idx: torch.Tensor, nl: int) -> torch.Tensor:
    """Per-rank take along the first dim after the ``nl`` rank dims:
    t (batch + (n,) + s), idx (batch) or (batch + (k,)) int → batch + s
    or batch + (k,) + s (``jnp.take(t, i, axis=0)`` in a rank's body)."""
    r, (n, *rest) = _rows(t, nl)
    lead = t.shape[:nl]
    ii = idx.reshape(r, -1).to(torch.int64)
    out = t.reshape(r, n, *rest)[torch.arange(r, device=t.device)[:, None],
                                 ii]
    if idx.dim() == nl:
        return out.reshape(*lead, *rest)
    return out.reshape(*lead, ii.shape[1], *rest)


def put_rows(t: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             nl: int) -> torch.Tensor:
    """Per-rank set of one row (``t.at[i].set(val)`` in a rank's body):
    t (batch + (n,) + s), idx (batch), val (batch + s) → a new tensor."""
    r, (n, *rest) = _rows(t, nl)
    out = t.clone()
    out.reshape(r, n, *rest)[torch.arange(r, device=t.device),
                             idx.reshape(r).to(torch.int64)] = val.reshape(
                                 r, *rest)
    return out
