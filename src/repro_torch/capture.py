"""CUDA-graph capture shared by the port's compiled steps, the
counterparts of the reference's ``jax.jit``: the serve engine's decode
step (``serve.CapturedStep``) and prefill (``serve.CapturedPrefill``)
and the train step (``train.CapturedTrainStep``).

A ``Capture`` is one graph with the side stream it is recorded on and
the owner of its kernels' accumulators.  ``warm_up`` runs a step once,
eagerly, on that stream under ``kernels.build.private_accumulators``:
it fills every table, accumulator, cuBLAS workspace and autograd setting
that the recording then reads.  ``capture`` gives the warm-up's cached
blocks back to the device, so that the graph's private pool does not
sit beside them, and records the step, which launches nothing;
``replay`` runs it.  Every capture on a device shares one side stream:
cuBLAS keeps a workspace for each stream it runs on and never frees it,
so a new stream for each capture would leave one more workspace on the
card at every epoch flip.  A graph records into a private memory pool of
its own, or into another graph's (``pool``): graphs that never run at
the same time may share one, each replay then free to overwrite what
another graph of the pool left in it (the prefill's graphs do, one
request shape each).

A replay runs no Python, so no kernel wrapper counts its launches:
``capture`` takes back from ``kernels.build.LAUNCHES`` what its
recording counted, and each ``replay`` adds it again.

``CapturedGraphs`` is the base of a compiled step: its plain version
and its graphs, one a key, which ``release()`` drops.  ``release`` calls
it on a compiled step and does nothing to a plain one.
``check_leaves`` is the buffers' guard: a tensor copied into a graph's
buffer must have the buffer's shape and dtype.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Sequence

import torch

from .kernels.build import LAUNCHES, add_launches, private_accumulators

__all__ = ["Capture", "CapturedGraphs", "check_leaves", "release"]

_OWNERS = itertools.count()
_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def check_leaves(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor],
                 what: str) -> None:
    """Raise a ``ValueError`` unless ``got`` has as many leaves as the
    buffers ``want``, each of the same shape and dtype; the message
    names the first leaf that differs, by index, and both shapes."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} {what} leaves, the captured step holds "
                         f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(
                f"{what} leaf {i} is {tuple(g.shape)} "
                f"{str(g.dtype).split('.')[-1]}, the captured step holds "
                f"{tuple(w.shape)} {str(w.dtype).split('.')[-1]}")


class CapturedGraphs:
    """A step compiled into CUDA graphs, one for each key its calls
    give: ``step`` is the plain version, run eagerly.  ``release()``
    drops every graph (its buffers and its memory pool) when the step's
    book epoch is superseded; the step stays usable and captures again
    at its next call."""

    def __init__(self, step):
        self.step = step
        self._graphs: Dict[Any, Any] = {}

    def release(self) -> None:
        self._graphs.clear()
        torch.cuda.empty_cache()        # the pools' memory to the device


def release(step) -> None:
    """Drop the graphs of a compiled step (``CapturedStep``,
    ``CapturedTrainStep``) when its epoch is superseded; a plain step
    holds none."""
    fn = getattr(step, "release", None)
    if fn is not None:
        fn()


class Capture:
    """One CUDA graph of a step on ``device``: its stream, its owner,
    its memory pool (``pool``: the one given, else the graph's own once
    recorded), the launches its recording counted (``launches``) and the
    host seconds of its warm-up and recording (``seconds``)."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.stream = _STREAMS.get(self.device)
        if self.stream is None:
            self.stream = _STREAMS[self.device] = torch.cuda.Stream(
                self.device)
        self.owner = next(_OWNERS)
        self.launches: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    def warm_up(self, fn, *args):
        """``fn(*args)`` run eagerly on the capture's stream, under its
        private accumulators; the caller's stream waits for it."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream), private_accumulators(self.owner):
            out = fn(*args)
        current.wait_stream(self.stream)
        self.seconds["warm_up"] = time.perf_counter() - t0
        return out

    def capture(self, fn, *args):
        """Record ``fn(*args)`` into the graph and return what it
        returned: tensors of the graph's pool, which every replay
        writes."""
        t0 = time.perf_counter()
        # the warm-up's cached blocks back to the device before the
        # graph's pool takes its own (torch.cuda.graph empties the cache
        # again on entry)
        torch.cuda.empty_cache()
        before = dict(LAUNCHES)
        with private_accumulators(self.owner):
            with torch.cuda.graph(self.graph, pool=self.pool,
                                  stream=self.stream):
                out = fn(*args)
        self.pool = self.graph.pool()
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                         if LAUNCHES[k] != before[k]}
        add_launches({k: -n for k, n in self.launches.items()})
        self.seconds["capture"] = time.perf_counter() - t0
        return out

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)
