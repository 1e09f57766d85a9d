"""The traced run's readings: host spans the harness puts around each
call into a layer, and ``torch.profiler`` (CUDA activity alone, so that
no host operation is recorded) over one steady slice of the window,
held in memory and reduced at once: no trace is written.

``Tracer.span(name)`` notes the host clock (``time.time_ns``, the
profiler's own time base) at its start and end while a slice is
profiled, and does nothing otherwise, so an untraced run pays nothing
for it.  ``Tracer.slice()`` profiles its body; ``summary`` then holds
the slice's length, the device's busy time (the union of its kernel,
copy and set intervals), each device operation's summed time and count
by name, the idle gaps by the innermost host span they fall in
(``host`` where none does), and how far the first and last device
operations lie inside the slice (a check that the two clocks agree).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_DEVICE_KINDS = ("kernel", "memcpy", "memset")


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.active = False
        self.summary: Optional[Dict] = None
        self._spans: List[Tuple[int, int, str]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._spans.append((t0, time.time_ns(), name))

    @contextlib.contextmanager
    def slice(self):
        if not self.enabled or self.summary is not None:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        cuda = torch.cuda.is_available()
        prof = profile(activities=[ProfilerActivity.CUDA] if cuda
                       else [ProfilerActivity.CPU])
        prof.__enter__()
        self.active = True
        t0 = time.time_ns()
        try:
            yield
            if cuda:
                torch.cuda.synchronize()
        finally:
            t1 = time.time_ns()
            self.active = False
            prof.__exit__(None, None, None)
        self.summary = reduce_events(prof.profiler.kineto_results.events(),
                                     self._spans, (t0, t1))
        self._spans = []


def _kind(e) -> str:
    """The event's activity kind where the profiler gives it (newer
    torch), else ``kernel``."""
    get = getattr(e, "activity_type", None)
    return str(get()).lower() if get is not None else "kernel"


def reduce_events(events, spans: Sequence[Tuple[int, int, str]],
                  bounds: Tuple[int, int]) -> Dict:
    dev: List[tuple] = []
    kinds = set()
    names = {s[2] for s in spans}
    for e in events:
        if "cuda" not in str(e.device_type()).lower():
            continue
        k = _kind(e)
        kinds.add(k)
        if any(t in k for t in _DEVICE_KINDS) and e.name() not in names:
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    t0, t1 = bounds
    op_s: Dict[str, float] = defaultdict(float)
    op_n: Dict[str, int] = defaultdict(int)
    for a, b, name in dev:
        op_s[name] += (b - a) * 1e-9
        op_n[name] += 1
    # union of device intervals, clipped to the slice
    iv = sorted((max(a, t0), min(b, t1)) for a, b, _ in dev
                if b > t0 and a < t1)
    merged: List[List[int]] = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps = []
    edge = t0
    for a, b in merged:
        if a > edge:
            gaps.append((edge, a))
        edge = b
    if t1 > edge:
        gaps.append((edge, t1))
    inner = sorted(spans, key=lambda s: s[1] - s[0])
    span_n: Dict[str, int] = defaultdict(int)
    for s in inner:
        span_n[s[2]] += 1
    if not inner:
        inner = [(-1, -1, "host")]
    starts = np.array([s[0] for s in inner], dtype=np.int64)
    ends = np.array([s[1] for s in inner], dtype=np.int64)
    gap_s: Dict[str, float] = defaultdict(float)
    g = np.array(gaps, dtype=np.int64).reshape(-1, 2)
    for lo in range(0, len(g), 1 << 14):
        part = g[lo:lo + (1 << 14)]
        mid = (part[:, 0] + part[:, 1]) // 2
        cover = (starts[None, :] <= mid[:, None]) & (ends[None, :]
                                                     >= mid[:, None])
        first = cover.argmax(axis=1)
        for (a, b), hit, j in zip(part, cover.any(axis=1), first):
            gap_s[inner[j][2] if hit else "host"] += (b - a) * 1e-9
    lead = (min(d[0] for d in dev) - t0) * 1e-9 if dev else None
    tail = (t1 - max(d[1] for d in dev)) * 1e-9 if dev else None
    return {"slice_s": (t1 - t0) * 1e-9, "busy_s": busy * 1e-9,
            "op_s": dict(op_s), "op_n": dict(op_n), "gap_s": dict(gap_s),
            "span_n": dict(span_n), "device_kinds": sorted(kinds),
            "first_op_s": lead, "after_last_op_s": tail}


def ops_matching(summary: Dict, parts) -> float:
    """Summed device seconds of the operations whose names contain any
    of ``parts``."""
    return sum(s for n, s in summary["op_s"].items()
               if any(p in n for p in parts))


def breakdown(summary: Dict) -> Dict[str, list]:
    top = sorted(summary["op_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["gap_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def idle_share(summary: Optional[Dict]) -> Optional[float]:
    """100 × (1 − busy / slice); nothing where the trace holds no device
    operation (a trace that saw no kernel measured nothing)."""
    if not summary or summary["busy_s"] <= 0 or summary["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["slice_s"])
