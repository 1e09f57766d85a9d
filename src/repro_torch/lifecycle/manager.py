"""Book lifecycle manager — epoch-versioned registries, EMA feeding,
monitored refresh, and the built-step cache (port of
``repro.lifecycle.manager``).

The paper keeps codebooks fixed *within* a deployment window and
refreshes them from the running-average PMF of previous batches,
entirely off the critical path (§4).  This module makes that policy a
first-class object:

  * the manager owns a ``CodebookRegistry`` and hands out **immutable
    per-epoch snapshots** — the train/serve step encodes against epoch N
    while observation and rebuilds prepare epoch N+1 on the host;
  * ``observe`` feeds the EMA *and* the drift monitor in one call;
    ``maybe_refresh`` rebuilds exactly the stale books and bumps the
    monotone ``book_epoch``;
  * a ``CompressionSpec`` carries its books' lengths, so a refresh means
    a new spec and a new step bound to it.  The ``compiled`` cache holds
    those steps keyed by ``(name, book_epoch)``: a builder runs at most
    once per epoch (``n_recompiles`` counts the builds, as the
    reference counts its jit compiles), and stale epochs are evicted;
  * ``save``/``load`` persist a **manifest** (epoch, content hash,
    stable ``book_id`` table) next to the registry blob, in the
    reference's format; load refuses a registry that does not reproduce
    the manifest bit-for-bit.

Cross-replica agreement on the epoch actually in use is the job of
``repro_torch.lifecycle.sync``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..comm.compression import CompressionSpec
from ..core.codebook import (Codebook, CodebookKey, CodebookRegistry,
                             RegistrySnapshot)
from .monitor import DriftMonitor, DriftReport, DriftThresholds

__all__ = ["BookLifecycleManager"]

_MANIFEST = "manifest.json"
_REGISTRY = "registry.npz"


def _host(value) -> np.ndarray:
    """A step's metric (a tensor on any device, or an array) as numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class BookLifecycleManager:
    """Owns the registry's epoch lifecycle: observe → detect → refresh."""

    def __init__(self, registry: Optional[CodebookRegistry] = None, *,
                 thresholds: Optional[DriftThresholds] = None,
                 monitor: Optional[DriftMonitor] = None):
        self.registry = registry if registry is not None else CodebookRegistry()
        self.monitor = monitor or DriftMonitor(thresholds)
        self._snapshot = self.registry.snapshot()
        self._spec_cache: Dict[Tuple, CompressionSpec] = {}
        self._compiled: Dict[Tuple[str, int], Any] = {}
        self.n_refreshes = 0
        self.n_recompiles = 0

    # ------------------------------------------------------------ epochs
    @property
    def book_epoch(self) -> int:
        return self._snapshot.epoch

    @property
    def snapshot(self) -> RegistrySnapshot:
        """The current epoch's immutable registry view."""
        return self._snapshot

    def _resnap(self) -> None:
        self._snapshot = self.registry.snapshot()
        # Steps and specs for superseded epochs are dead weight (nothing
        # will encode against those books again) — evict them.
        self._compiled = {k: v for k, v in self._compiled.items()
                          if k[1] == self._snapshot.epoch}
        self._spec_cache = {k: v for k, v in self._spec_cache.items()
                            if k[0] == self._snapshot.epoch}

    # ------------------------------------------------------- observation
    def install(self, key: CodebookKey, counts: np.ndarray) -> Codebook:
        """Bootstrap path: observe + build in one shot (bumps the epoch)."""
        book = self.registry.install(key, counts)
        self._resnap()
        return book

    def observe(self, key: CodebookKey,
                counts: np.ndarray) -> Optional[DriftReport]:
        """Feed one window's histogram: EMA (for the next rebuild) and
        drift measurement against the installed book.  Cheap host work —
        call it off the critical path with the step's probe histograms.
        Returns the drift report (None until a book exists for ``key``).
        """
        self.registry.observe(key, counts)
        if key in self.registry:
            return self.monitor.observe(key, counts, self.registry.get(key))
        return None

    def stale_keys(self) -> List[CodebookKey]:
        return self.monitor.stale_keys()

    # ----------------------------------------------------------- refresh
    def maybe_refresh(self, force: bool = False) -> Optional[int]:
        """Rebuild stale books (all books when ``force``) and open a new
        epoch.  Returns the new ``book_epoch``, or None if nothing was
        stale.  The rebuild itself is host-side package-merge over the
        EMA histograms — off the critical path; the step's cost is the
        rebuild the next ``compiled()``/``spec()`` call pays (new device
        tables for the new books), which is why refreshes are batched
        behind the monitor's patience."""
        stale = self.stale_keys()
        if not stale and not force:
            return None
        self.registry.rebuild(None if force else stale)
        for key in (self.registry.keys() if force else stale):
            self.monitor.reset(key)
        self._resnap()
        self.n_refreshes += 1
        return self.book_epoch

    # ----------------------------------------------------- device views
    def books(self, tensor_kind: str,
              scheme_name: str = "bf16") -> Dict[str, Codebook]:
        """Plane → Codebook mapping for the ring/chunked transports,
        resolved against the current epoch's snapshot."""
        from ..core.symbols import SCHEMES
        return {plane: self._snapshot.get((tensor_kind, scheme_name, plane))
                for plane in SCHEMES[scheme_name].planes}

    def spec(self, tensor_kind: str, scheme_name: str = "bf16",
             mode: str = "ledger", **kw) -> CompressionSpec:
        """Epoch-bound ``CompressionSpec`` (cached per epoch + config).

        Built from the frozen snapshot — not the live registry — so a
        background thread rebuilding ``self.registry`` directly can
        never hand out books from an epoch the manager hasn't flipped
        to (``spec``/``books``/``compiled`` stay mutually consistent).
        """
        cache_key = (self.book_epoch, tensor_kind, scheme_name, mode,
                     tuple(sorted(kw.items())))
        if cache_key not in self._spec_cache:
            self._spec_cache[cache_key] = CompressionSpec.from_registry(
                self._snapshot, tensor_kind, scheme_name, mode=mode, **kw)
        return self._spec_cache[cache_key]

    def respec(self, spec: CompressionSpec) -> CompressionSpec:
        """The same wire configuration re-bound to the current epoch's
        books — what a step holder calls after an epoch flip."""
        return self.spec(spec.tensor_kind, spec.scheme_name, mode=spec.mode,
                         transport=spec.transport, chunk=spec.chunk,
                         codec=spec.codec,
                         decode_backend=spec.decode_backend, carry=spec.carry,
                         axes=spec.axes)

    def compiled(self, name: str, build_fn: Callable[
            ["BookLifecycleManager"], Any]) -> Any:
        """Built-step cache keyed by ``(name, book_epoch)``.

        ``build_fn(manager)`` returns the step (a callable) bound to this
        epoch's spec; it runs at most once per epoch — an epoch flip is
        the one deliberate, amortized rebuild the lifecycle allows,
        counted in ``n_recompiles``.

        ``name`` must uniquely identify the builder's *configuration*,
        not just its role: two holders sharing one manager under the
        same name get the same step, so fold every config knob that
        changes the build (degrees, chunk, backend…) into the name — see
        ``serve.Engine._compile_step``.
        """
        key = (name, self.book_epoch)
        if key not in self._compiled:
            self._compiled[key] = build_fn(self)
            self.n_recompiles += 1
        return self._compiled[key]

    # ------------------------------------------------------- persistence
    def save(self, dirpath: str) -> str:
        """Write ``registry.npz`` + ``manifest.json`` under ``dirpath``.

        The manifest records the epoch, the content hash and the stable
        ``book_id`` table; ``load`` verifies the reloaded registry
        reproduces all three, so a spec built from the reload is
        hash-identical to one built before the save.  Both files are
        the reference's format: either package loads the other's."""
        os.makedirs(dirpath, exist_ok=True)
        self.registry.save(os.path.join(dirpath, _REGISTRY))
        snap = self._snapshot
        manifest = {
            "format": 1,
            "book_epoch": snap.epoch,
            "content_hash": snap.content_hash,
            "n_symbols": self.registry.n_symbols,
            "ema": self.registry.ema,
            "max_len": self.registry.max_len,
            "codec": self.registry.codec,
            "books": [{"book_id": b.book_id, "key": list(b.key),
                       "payload_bits_on_source": int(b.encoded_bits(
                           b.source_counts))}
                      for b in snap.books],
        }
        path = os.path.join(dirpath, _MANIFEST)
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, dirpath: str, *,
             thresholds: Optional[DriftThresholds] = None
             ) -> "BookLifecycleManager":
        with open(os.path.join(dirpath, _MANIFEST)) as f:
            manifest = json.load(f)
        registry = CodebookRegistry.load(os.path.join(dirpath, _REGISTRY))
        if manifest.get("codec", "huffman") != registry.codec:
            raise ValueError(
                f"manifest codec {manifest.get('codec')!r} != registry "
                f"blob codec {registry.codec!r}")
        snap = registry.snapshot()
        if snap.epoch != manifest["book_epoch"]:
            raise ValueError(
                f"manifest epoch {manifest['book_epoch']} != reloaded "
                f"registry epoch {snap.epoch}")
        if snap.content_hash != manifest["content_hash"]:
            raise ValueError(
                "reloaded registry content hash does not match the "
                "manifest — blob and manifest are from different epochs")
        for entry, book in zip(manifest["books"], snap.books):
            if (entry["book_id"] != book.book_id
                    or tuple(entry["key"]) != book.key):
                raise ValueError(
                    f"manifest book table mismatch at id {book.book_id}")
        return cls(registry, thresholds=thresholds)

    # --------------------------------------------------------- reporting
    def observe_train_metrics(self, metrics, tensor_kind: str = "grad",
                              scheme_name: str = "bf16",
                              prefix: str = "grad_hist_"
                              ) -> Dict[str, DriftReport]:
        """Feed a train/serve step's ``*_hist_<plane>`` metrics (tensors
        on any device, or arrays) into the lifecycle: one host copy of
        each histogram the step already computed (kernel B5 on the
        card)."""
        reports = {}
        for name, value in metrics.items():
            if not name.startswith(prefix):
                continue
            plane = name[len(prefix):]
            report = self.observe((tensor_kind, scheme_name, plane),
                                  _host(value))
            if report is not None:
                reports[plane] = report
        return reports
