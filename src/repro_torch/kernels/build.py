"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into its own shared library with a plain C interface, loaded through
``ctypes``: a build of seconds, where a source that includes PyTorch's
headers takes minutes.  Libraries land in ``_build/`` beside this file
(``REPRO_TORCH_KERNEL_DIR`` overrides it), named by a digest of the
source, the shared header and the flags, so an edited source rebuilds
and an unchanged one loads at once.

``build_all()`` starts one ``nvcc`` per source, all at the same time,
and waits for them; a wrapper's first launch otherwise builds just its
own library.  Every failure raises with the compiler's output.

The launch counters live here too: each wrapper adds one to its entry
of ``LAUNCHES`` where it launches its kernel, and nowhere else, so a run
can show that its main path went through the kernels.  A CUDA graph's
replay runs no Python: a captured step takes back what its capture
counted (``add_launches`` with the negated counts) and adds it again on
every replay.

B1 and B5 keep a small accumulator on the device for each stream they
run on (``accumulator_key``).  Work captured in a graph runs whenever
the graph is replayed, on whatever stream, so a captured step warms up
and captures inside ``private_accumulators(owner)``: its launches get
accumulators of their own, which no other graph or eager call shares.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

__all__ = ["CSRC", "SOURCES", "LAUNCHES", "reset_launches", "count_launch",
           "add_launches", "accumulator_key", "private_accumulators",
           "build_dir", "nvcc_path", "build_all", "library", "build_logs",
           "bind", "check", "raise_on", "raw_stream", "P", "I", "LL", "U"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("encode", "bitpack", "decode", "histogram", "decode_matmul")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"encode_lookup": 0, "pack_blocks": 0,
                            "decode_chunks_canonical": 0,
                            "decode_chunks_multisym": 0, "histogram256": 0,
                            "decode_chunks_qlc": 0, "decode_matmul": 0,
                            "decode_matmul_qlc": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], Callable[..., int]] = {}
_LOGS: Dict[str, str] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (name -> launches) to ``LAUNCHES``: a graph's
    replay adds the launches its capture recorded."""
    for k, n in counts.items():
        LAUNCHES[k] += n


_OWNER: contextvars.ContextVar = contextvars.ContextVar(
    "accumulator_owner", default=None)


def accumulator_key(index: int, stream: int):
    """The key of a kernel's device accumulator: the device, the raw
    stream and the owner that ``private_accumulators`` set (None for
    eager calls)."""
    return index, stream, _OWNER.get()


@contextlib.contextmanager
def private_accumulators(owner):
    """Within: B1's and B5's accumulators are keyed by ``owner`` too, so
    launches captured in a graph never share one with another graph or
    with eager calls on the same stream."""
    token = _OWNER.set(owner)
    try:
        yield
    finally:
        _OWNER.reset(token)


def build_dir() -> Path:
    d = os.environ.get("REPRO_TORCH_KERNEL_DIR")
    return Path(d) if d else Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    """nvcc from ``$CUDA_HOME`` (as PyTorch resolves it), else ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc into a temporary file; None if already built."""
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    proc = subprocess.Popen(
        [nvcc, *FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, target = job
    out, _ = proc.communicate()
    _LOGS[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)
    (target.parent / f"{target.stem}.log").write_text(out)


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every source (one nvcc each, all started together) and
    load them.  Returns name → library path."""
    names = tuple(names or SOURCES)
    with _LOCK:
        nvcc = nvcc_path()
        jobs = {n: _start(n, nvcc) for n in names if n not in _LIBS}
        errors = []
        for n, job in jobs.items():        # wait for every nvcc started
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n\n".join(errors))
        for n in jobs:
            _LIBS[n] = ctypes.CDLL(str(_target(n)))
    return {n: _target(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]


P, I, LL, U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
               ctypes.c_uint)


def bind(lib_name: str, fn_name: str, argtypes):
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu`` with its argument
    types declared (``P`` for pointers and the stream, so none is cut to
    32 bits; ``I`` / ``LL`` / ``U`` for int, long long and unsigned int)
    and returning its ``cudaError_t``.
    Bound once per process; later calls return the same entry."""
    key = (lib_name, fn_name)
    fn = _FNS.get(key)
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return fn


def check(t, name: str, dtype, device, shape=None) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype``, is
    contiguous and, where given, has ``shape``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raw_stream(index: int) -> int:
    """PyTorch's current stream on CUDA device ``index`` as the raw
    ``cudaStream_t`` (an int), without building a ``torch.cuda.Stream``."""
    import torch
    return torch._C._cuda_getCurrentRawStream(index)


def raise_on(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def build_logs() -> Dict[str, str]:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills)
    for every source built in this process."""
    return dict(_LOGS)
