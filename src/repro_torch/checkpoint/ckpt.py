"""Checkpointing: flat-key npz snapshots of parameter trees with dtype
preservation (port of ``repro.checkpoint.ckpt``).

A tree is nested dicts, tuples and lists of tensors.  ``_flatten`` names
every leaf as the reference does — path entries joined by ``/``, dict
keys as themselves, sequence indices as ``[i]``, dicts in sorted key
order (JAX's flattening order) — so a checkpoint or manifest written by
either package reads in the other.  bfloat16 rides as a uint16 view with
a ``"bfloat16"`` dtype tag, as in the reference.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["save_pytree", "load_pytree", "leaf_to_numpy",
           "leaf_from_numpy", "dtype_name"]

_SEP = "/"


def _items(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(f"[{i}]", v) for i, v in enumerate(tree)]


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{name: leaf} in the reference's order and with its key names."""
    if not isinstance(tree, (dict, list, tuple)):
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for key, sub in _items(tree):
        flat.update(_flatten(sub, f"{prefix}{_SEP}{key}" if prefix else key))
    return flat


def _unflatten(like, flat: Dict[str, Any], prefix: str = ""):
    """The tree shaped as ``like`` whose leaf at each name is
    ``flat[name]``."""
    if not isinstance(like, (dict, list, tuple)):
        return flat[prefix]

    def name(key):
        return f"{prefix}{_SEP}{key}" if prefix else key

    if isinstance(like, dict):
        return {k: _unflatten(like[k], flat, name(str(k))) for k in like}
    return type(like)(_unflatten(v, flat, name(f"[{i}]"))
                      for i, v in enumerate(like))


def _skeleton(tree):
    """``tree``'s structure with every leaf replaced by None: a template
    for ``_unflatten`` that holds no tensor alive."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v) for v in tree)
    return None


def dtype_name(t: torch.Tensor) -> str:
    """The NumPy-style dtype name the reference records (``float32``,
    ``bfloat16``, …)."""
    return str(t.dtype).replace("torch.", "")


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as NumPy, bfloat16 as its uint16 bit pattern."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def leaf_from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """The inverse of ``leaf_to_numpy`` for a recorded dtype name."""
    a = np.array(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def save_pytree(path: str, tree, extra_meta: Optional[Dict] = None) -> None:
    flat = _flatten(tree)
    blob: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    for k, v in flat.items():
        dtypes[k] = dtype_name(v)
        blob[k] = leaf_to_numpy(v)
    meta = {"dtypes": dtypes, "extra": extra_meta or {}}
    blob["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                     dtype=np.uint8)
    np.savez(path, **blob)


def load_pytree(path: str, like=None, *, device=None) -> Tuple[Any, Dict]:
    """Restore onto ``device`` (CUDA unless named).  With ``like`` (a
    template tree) the result has its structure; otherwise a flat
    {key: tensor} dict is returned."""
    dev = resolve_device(device)
    blob = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(blob["__meta__"]).decode())
    flat = {k: leaf_from_numpy(blob[k], meta["dtypes"][k], dev)
            for k in blob.files if k != "__meta__"}
    if like is None:
        return flat, meta["extra"]
    template = _flatten(like)
    if set(template) != set(flat):
        missing = set(template) ^ set(flat)
        raise ValueError(f"checkpoint/tree key mismatch: {sorted(missing)[:5]}")
    return _unflatten(like, flat), meta["extra"]
