"""Serving engine (port of ``repro.serve.engine``): batched prefill +
autoregressive decode, with fixed-codebook compression accounting on
the decode-step activations.

In ``bitexact`` mode every decode step runs the paper's single-stage
wire on its bf16 logits: the byte planes' histograms and coded size
(``payload_stats``), the chunked encode (kernel B1 → B2 on the card),
the chunked decode through the spec's backend (B4 for ``multisym``, B3
for ``scan``) and a mismatch count that must stay 0.  The metrics dict
has the reference's keys.

Compressed-at-rest serving: ``param_store=`` (a
``memstore.CompressedParamStore``) decodes the parameters once, on the
card, when the engine is built (kernel B4 or B6); ``kv_mode="coded"``
holds the KV cache in a ``memstore.CodedKVStore`` that codes each step's
new slots and serves every step from a decoded read; ``hbm_stats``
reports both ledgers.

Book hot-refresh: ``lifecycle=`` (a ``lifecycle.BookLifecycleManager``)
observes every step's activation histograms and, every
``refresh_every`` tokens, lets the manager rebuild stale books; an epoch
flip re-binds the spec and swaps in the step built for the new books.

Expert parallelism: with ``ep_degree > 1`` and an MoE model, each step
reports ``moe_wire_raw_bits``, the analytic raw bits of its expert
dispatch and combine on an ``ep_degree``-way all-to-all (the decode's
experts run on this device; ``models.moe.moe_apply_a2a`` is the coded
wire itself).  MLA models serve from their latent caches
(``models.mla``), the recurrent kinds from their fixed-size states
(``models.rglru``, ``models.ssm``); under ``kv_mode="coded"`` the
``CodedKVStore`` codes only ``{k, v, pos}`` nodes, so a latent cache or
a recurrent state stays raw, as in the reference.

The compiled decode step: on CUDA the engine runs ``make_serve_step``'s
step as a ``CapturedStep``, captured once as a CUDA graph for each batch
size (and each book epoch under a lifecycle manager) and replayed for
every decode step, with the token, the position and the caches in the
graph's own device buffers (the reference's ``jax.jit`` of the step with
its traced ``jnp.int32`` position).  ``make_serve_step`` is its plain
version, and the step the engine runs on the CPU.

The compiled prefill: on CUDA the engine runs ``prefill`` as a
``CapturedPrefill``, captured once as a CUDA graph for each request
shape and replayed for every later request of that shape (the
reference's ``jax.jit`` of ``prefill``, which compiles once a shape);
the graphs of an engine share one memory pool, so a prefill's logits and
caches are valid until the engine's next prefill.  An epoch flip leaves
them: the prefill reads no book.  On the CPU the prefill runs eagerly.

Prefix embeddings: ``generate(prompt_tokens, n, prefix_embeds=)`` runs
the prefill on [prefix] + [prompt] (a VLM's patch embeddings), so the
caches (and a coded KV store's first ingest) hold the prefix's slots
too and decoding starts after both.  An encoder-only config
(``prefix_only``, the audio model) has no decode step: ``Engine``
refuses it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..capture import Capture, CapturedGraphs, check_leaves, release
from ..comm.compression import CompressionSpec, payload_stats
from ..comm.transport import (decode_blocks, encode_planes, moe_ep_raw_bits,
                              wire_factor)
from ..core.codec import get_codec
from ..core.encoder import DEFAULT_CHUNK, chunk_counts_for, concat_chunks
from ..device import metrics_to_host, resolve_device
from ..models.common import ModelConfig, tree_leaves, tree_map
from ..models.layers import decode_pos
from ..models.transformer import decode_step, prefill

__all__ = ["ServeConfig", "Engine", "CapturedStep", "CapturedPrefill",
           "make_serve_step", "make_activation_probe"]

_SCALARS = ("act_raw_bits", "act_coded_bits", "act_wire_raw_bits",
            "act_wire_coded_bits", "act_decoded_bits", "act_decode_chunks",
            "act_decode_mismatch", "moe_wire_raw_bits")


@dataclass(frozen=True)
class ServeConfig:
    max_cache_len: int
    temperature: float = 0.0   # 0 → greedy
    seed: int = 0


def make_activation_probe(comp_spec: Optional[CompressionSpec], *,
                          decode_chunk: Optional[int] = None,
                          tp_degree: int = 1):
    """logits → the decode step's activation metrics (the wire's part of
    ``make_serve_step``).

    With a spec, metrics carry the bf16 logits' raw and coded bits, the
    Shannon floor and per-plane histograms, and — for a
    ``tp_degree``-way link — the all-gather's wire bits.  In
    ``bitexact`` mode the probe also encodes and decodes the planes at
    the spec's chunk through the spec's backend, with books rebuilt from
    the spec's length vectors (what a receiving peer holds), and counts
    decoded bits, chunks and mismatches.  Metrics are 0-d tensors on the
    logits' device (float64, exact); nothing here waits for the device.
    """
    if decode_chunk is None:
        decode_chunk = (comp_spec.chunk if comp_spec is not None
                        else DEFAULT_CHUNK)
    books = None
    if (comp_spec is not None and comp_spec.enabled
            and comp_spec.mode == "bitexact"):
        codec = get_codec(comp_spec.codec)
        books = {plane: codec.book_from_lengths(
                     np.asarray(lens, dtype=np.int32),
                     key=(comp_spec.tensor_kind, comp_spec.scheme_name,
                          plane))
                 for plane, lens in comp_spec.plane_lengths}
    counts_cache: Dict[Tuple[int, str], torch.Tensor] = {}

    def chunk_counts(n: int, device) -> torch.Tensor:
        key = (n, str(device))
        if key not in counts_cache:
            counts_cache[key] = torch.from_numpy(
                chunk_counts_for(n, decode_chunk)).to(device)
        return counts_cache[key]

    def probe(logits: torch.Tensor) -> Dict[str, torch.Tensor]:
        z = torch.zeros((), dtype=torch.float64, device=logits.device)
        metrics = {k: z for k in _SCALARS}
        if comp_spec is None or not comp_spec.enabled:
            return metrics
        h = logits.to(torch.bfloat16)
        s = payload_stats(h, comp_spec, with_hists=True)
        metrics["act_raw_bits"] = s["raw_bits"]
        metrics["act_coded_bits"] = s["coded_bits"]
        metrics["act_shannon_bits"] = s["shannon_bits"]
        metrics["book_epoch"] = z + float(comp_spec.book_epoch)
        for plane in comp_spec.scheme.planes:
            metrics[f"act_hist_{plane}"] = s[f"hist_{plane}"]
        if tp_degree > 1:
            factor = wire_factor("all_gather", tp_degree)
            metrics["act_wire_raw_bits"] = factor * s["raw_bits"]
            metrics["act_wire_coded_bits"] = factor * s["coded_bits"]
        if books is not None:
            enc = encode_planes(h, books, comp_spec.scheme_name,
                                chunk=decode_chunk)
            decoded = torch.zeros((), dtype=torch.int64, device=h.device)
            mismatch = torch.zeros((), dtype=torch.int64, device=h.device)
            n_chunks = 0
            for plane, (words, bits, sym) in enc.items():
                n = int(sym.shape[0])
                out = decode_blocks(words, chunk_counts(n, h.device),
                                    books[plane], decode_chunk,
                                    comp_spec.decode_backend)
                dec = concat_chunks(out, chunk_counts_for(n, decode_chunk))
                decoded = decoded + bits.to(torch.int64).sum()
                mismatch = mismatch + (dec != sym).sum()
                n_chunks += words.shape[0]
            metrics["act_decoded_bits"] = decoded.to(torch.float64)
            metrics["act_decode_chunks"] = z + float(n_chunks)
            metrics["act_decode_mismatch"] = mismatch.to(torch.float64)
        return metrics

    return probe


def make_serve_step(model_cfg: ModelConfig,
                    comp_spec: Optional[CompressionSpec] = None, *,
                    decode_chunk: Optional[int] = None, tp_degree: int = 1,
                    ep_degree: int = 1):
    """(params, tokens (B,1), caches, pos) → (logits, caches, metrics):
    one decode step, then ``make_activation_probe``'s metrics of its
    logits and, with ``ep_degree > 1``, ``moe_wire_raw_bits``.  ``pos``
    is a 0-d int32 tensor on the step's device or an int.  Run eagerly,
    this is the plain version of ``CapturedStep``."""
    probe = make_activation_probe(comp_spec, decode_chunk=decode_chunk,
                                  tp_degree=tp_degree)

    def step(params, tokens, caches, pos):
        logits, caches = decode_step(params, tokens, caches, pos, model_cfg)
        metrics = probe(logits)
        moe = (moe_ep_raw_bits(model_cfg, tokens.shape[0],
                               comp_spec.scheme.total_symbol_bits(),
                               ep_degree)[1]
               if comp_spec is not None and comp_spec.enabled else 0.0)
        if moe:
            metrics["moe_wire_raw_bits"] = metrics["moe_wire_raw_bits"] + moe
        return logits, caches, metrics

    return step


class _Graph:
    """One capture of a step: its input buffers (token, position,
    caches), its outputs and its ``capture.Capture``.  It holds the
    parameters it was captured with, whose tensors the graph reads."""

    def __init__(self, params, tokens, caches, pos):
        self.params = params
        self.tokens = tokens.clone()
        self.pos = decode_pos(pos, tokens.device).to(torch.int32, copy=True)
        self.caches = tree_map(torch.clone, caches)
        self.leaves = tree_leaves(self.caches)
        self.capture = Capture(tokens.device)
        self.outputs = None

    def load(self, tokens, caches, pos) -> None:
        """The call's inputs into the buffers, on the device: no host
        read.  Caches already in the buffers (the last call's output)
        are not copied; a cache leaf of another shape or dtype raises."""
        self.tokens.copy_(tokens)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(pos)
        leaves = tree_leaves(caches)
        check_leaves(leaves, self.leaves, "cache")
        for dst, src in zip(self.leaves, leaves):
            if src is not dst:
                dst.copy_(src)


class CapturedStep(CapturedGraphs):
    """A serve step captured as a CUDA graph and replayed: the port's
    counterpart of the reference's ``jax.jit`` of ``make_serve_step``.

    Called as the step it wraps, ``(params, tokens (B, 1), caches, pos)
    → (logits, caches, metrics)``, with ``pos`` an int or a 0-d int32
    tensor.  The first call for a batch size (and parameter tree)
    captures: one eager run of ``step`` on scratch copies of the caches
    (``Capture.warm_up``: it leaves the served caches as they are), then
    the capture, on a stream of its own.  Every call copies its token and
    position into the graph's buffers, and its caches unless they are
    the graph's own (the last call's output), then replays.  The logits,
    caches and metrics it returns are the graph's buffers, which the
    next call overwrites.  Nothing falls back to the eager step: a
    capture or replay that fails raises.

    ``release()`` drops every graph, its cache buffers included, when
    the step's book epoch is superseded.  Tensors a caller still holds,
    such as the last call's caches, stay valid: only the graph's
    references go.  Launch counts and accumulators: see ``capture``.
    """

    @torch.no_grad()
    def __call__(self, params, tokens, caches, pos):
        key = (tokens.shape[0], id(params))
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(params, tokens, caches, pos)
            self._graphs[key] = g
        else:
            g.load(tokens, caches, pos)
        g.capture.replay()
        logits, metrics = g.outputs
        return logits, g.caches, metrics

    def _capture(self, params, tokens, caches, pos) -> _Graph:
        g = _Graph(params, tokens, caches, pos)
        g.capture.warm_up(self.step, params, g.tokens,
                          tree_map(torch.clone, g.caches), g.pos)
        logits, out, metrics = g.capture.capture(self.step, params, g.tokens,
                                                 g.caches, g.pos)
        if out is not g.caches:
            raise RuntimeError("the captured step did not update its "
                               "caches in place")
        g.outputs = (logits, metrics)
        return g


class _PrefillGraph:
    """One capture of the prefill at a request shape: its input buffers
    (tokens, and the prefix if any), the parameters it reads, its
    outputs and its ``capture.Capture``."""

    def __init__(self, step, params, batch, capture):
        self.step, self.params, self.capture = step, params, capture
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.outputs = None

    def body(self):
        logits, caches = self.step(self.params, self.batch)
        return {"logits": logits, "caches": caches}

    def load(self, batch) -> None:
        """The request's inputs into the buffers, on the device: no host
        read."""
        for k, v in batch.items():
            self.batch[k].copy_(v)


class CapturedPrefill(CapturedGraphs):
    """The prefill captured as a CUDA graph and replayed: the port's
    counterpart of the reference's ``jax.jit(partial(prefill, cfg=...,
    cache_len=...))``.

    Built on that ``partial`` (``step``) and called as it is, ``(params,
    batch) → (logits, caches)`` with ``batch`` ``{"tokens": (B, S)
    int64[, "prefix_embeds": (B, P, d)]}``.  The first call for a batch
    signature (each input's shape and dtype) and parameter tree copies
    the inputs into static buffers, runs one eager prefill on them
    (``Capture.warm_up``, its result dropped), records the prefill and
    replays it: a new shape costs one warm-up and one recording, as it
    costs the reference a compile.  Every later call of that signature
    copies its inputs into the buffers on the device and replays.  The
    logits and caches returned are a graph's buffers, equal bit for bit
    to the eager prefill's on the same inputs.  Nothing falls back to
    the eager prefill: a capture or replay that fails raises.

    All graphs record into one memory pool (the first graph's), since
    prefill replays run one at a time on one stream: a replay may
    overwrite the outputs of another shape's.  So the logits and caches
    a call returns stay valid until the next call, of any shape; the
    engine consumes them first (the sample, a coded store's ingest and
    read, the decode graph's copy of the caches).  ``release()`` drops
    every graph and the pool.
    """

    def __init__(self, step):
        super().__init__(step)
        self._pool = None

    @torch.no_grad()
    def __call__(self, params, batch):
        key = (tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items())), id(params))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(params, batch)
        else:
            g.load(batch)
        g.capture.replay()
        return g.outputs["logits"], g.outputs["caches"]

    def _capture(self, params, batch) -> _PrefillGraph:
        device = next(iter(batch.values())).device
        g = _PrefillGraph(self.step, params, batch,
                          Capture(device, pool=self._pool))
        g.capture.warm_up(g.body)
        g.outputs = g.capture.capture(g.body)
        self._pool = g.capture.pool
        return g

    def release(self) -> None:
        self._pool = None
        super().release()


class Engine:
    """Batched-request engine over the port's model functions.

    Runs on ``device`` (CUDA unless named); the parameters (or the
    param store) must already lie there.  On CUDA each decode step is a
    replay of the step captured for the batch size (``CapturedStep``)
    and each prefill a replay of the prefill captured for the request's
    shape (``CapturedPrefill``, built once here and kept across epoch
    flips); on the CPU both run eagerly.  ``generate`` takes one host
    sync per decode step for its scalar metrics (a coded KV cache adds
    its own: see ``memstore.kvstore``), and keeps each step's scalars
    (plus its wall time, ``step_seconds``) in ``step_metrics``.

    With a ``lifecycle`` manager the same copy carries the step's
    ``act_hist_<plane>`` arrays too (kept in ``step_metrics``); the
    engine feeds them into the manager and — every ``refresh_every``
    generated tokens — lets it rebuild stale books.  An epoch flip
    re-binds the spec to the new books, releases the superseded step's
    graphs and takes the step the manager's epoch-keyed cache builds for
    them: between decode steps, never inside one.  ``epoch_specs`` maps
    each book epoch of the last ``generate`` call to the spec in force
    at it.
    """

    def __init__(self, params, model_cfg: ModelConfig, serve_cfg: ServeConfig,
                 comp_spec: Optional[CompressionSpec] = None,
                 tp_degree: int = 1, ep_degree: int = 1,
                 lifecycle=None, refresh_every: int = 16,
                 param_store=None, kv_mode: str = "raw", device=None):
        if lifecycle is not None and comp_spec is None:
            raise ValueError("a lifecycle manager needs a comp_spec naming "
                             "the tensor kind / scheme / wire config")
        if kv_mode not in ("raw", "coded"):
            raise ValueError(f"kv_mode must be 'raw' or 'coded', "
                             f"got {kv_mode!r}")
        if model_cfg.prefix_only:
            raise ValueError(f"{model_cfg.name} is an encoder over prefix "
                             f"embeddings (prefix_only): it has no decode "
                             f"step to serve")
        self.device = resolve_device(device)
        if param_store is not None:
            if params is not None:
                raise ValueError("pass either params or param_store, not "
                                 "both")
            # Decode-on-load: the store stays the source of truth for the
            # footprint ledger; the working copy is materialized once.
            params = param_store.materialize_tree()
        self.param_store = param_store
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params lie on {table.device}, the engine "
                             f"runs on {self.device}")
        self.params = params
        self.cfg = model_cfg
        self.serve = serve_cfg
        self._spec = comp_spec
        self._tp = tp_degree
        self._ep = ep_degree
        self.lifecycle = lifecycle
        self.refresh_every = refresh_every
        self.kv_mode = kv_mode
        self._kv = self._make_kvstore() if kv_mode == "coded" else None
        self._prefill = partial(prefill, cfg=model_cfg,
                                cache_len=serve_cfg.max_cache_len)
        if self.device.type == "cuda":
            self._prefill = CapturedPrefill(self._prefill)
        self._step = self._compile_step()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(serve_cfg.seed)
        self.step_metrics: List[Dict[str, float]] = []
        self.epoch_specs: Dict[int, CompressionSpec] = {}

    def _make_kvstore(self):
        """The coded-KV store, with books resolved in preference order:
        the lifecycle manager's current activation books, the spec's
        canonical plane lengths (what a receiving peer rebuilds) or,
        without either, books the store builds from the first ingest's
        K/V through the param store's codec.  Books are pinned per store
        — an epoch flip mid-generate must not re-key segments already
        coded — so ``generate`` makes a fresh store per call."""
        from ..memstore.kvstore import DEFAULT_KV_CHUNK, CodedKVStore
        spec = self._spec
        if self.lifecycle is not None:
            books = self.lifecycle.books(spec.tensor_kind, spec.scheme_name)
            return CodedKVStore(books, chunk=spec.chunk, device=self.device)
        if spec is not None and spec.enabled and spec.plane_lengths:
            codec = get_codec(spec.codec)
            books = {plane: codec.book_from_lengths(
                         np.asarray(lens, dtype=np.int32),
                         key=(spec.tensor_kind, spec.scheme_name, plane))
                     for plane, lens in spec.plane_lengths}
            return CodedKVStore(books, chunk=spec.chunk, device=self.device)
        if self.param_store is not None:
            return CodedKVStore(codec=self.param_store.codec,
                                chunk=DEFAULT_KV_CHUNK, device=self.device)
        raise ValueError("kv_mode='coded' needs books: pass a comp_spec "
                         "with activation books, or a param_store")

    def _compile_step(self):
        """The decode step for the current spec (a ``CapturedStep`` on
        CUDA, which captures at its first call for each batch size; the
        plain step on the CPU): built directly, or through the
        lifecycle's epoch-keyed cache under a name that carries every
        build-changing knob (engine degrees and the spec's whole wire
        config), so two engines sharing one manager never share a step
        built for another configuration."""
        def build(_=None):
            step = make_serve_step(self.cfg, self._spec, tp_degree=self._tp,
                                   ep_degree=self._ep)
            return CapturedStep(step) if self.device.type == "cuda" else step
        if self.lifecycle is None:
            return build()
        s = self._spec
        name = (f"serve_step/{self.cfg.name}/{s.tensor_kind}"
                f"/tp{self._tp}ep{self._ep}/{s.mode}/{s.scheme_name}"
                f"/{s.transport}/c{s.chunk}/{s.decode_backend}/{s.carry}"
                f"/{s.axes}")
        return self.lifecycle.compiled(name, build)

    def _maybe_refresh(self) -> bool:
        """Let the manager rebuild stale books; release the superseded
        step and swap in the new epoch's spec and step.  Returns True on
        an epoch flip."""
        if self.lifecycle is None:
            return False
        if self.lifecycle.maybe_refresh() is None:
            return False
        self._spec = self.lifecycle.respec(self._spec)
        # the superseded epoch's graphs (cache copies, pools) go; the
        # caches this generate holds are its tensors and stay.  The
        # prefill's graphs read no book, and stay.
        release(self._step)
        self._step = self._compile_step()
        self.epoch_specs[self._spec.book_epoch] = self._spec
        return True

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1]
        if self.serve.temperature <= 0.0:
            return torch.argmax(last, dim=-1)[:, None]
        p = torch.softmax(last.to(torch.float32) / self.serve.temperature,
                          dim=-1)
        return torch.multinomial(p, 1, generator=self._gen)

    @torch.no_grad()
    def generate(self, prompt_tokens, max_new_tokens: int,
                 prefix_embeds=None) -> Tuple[np.ndarray, Dict[str, float]]:
        """prompt_tokens: (B, S) ints → (B, max_new_tokens) generated ids
        and the summed metrics.  ``prefix_embeds`` (B, P, d), when given,
        precede the prompt (cast to the model's dtype by the model)."""
        tokens = torch.as_tensor(prompt_tokens).to(device=self.device,
                                                   dtype=torch.int64)
        batch = {"tokens": tokens}
        if prefix_embeds is not None:
            batch["prefix_embeds"] = torch.as_tensor(prefix_embeds).to(
                self.device)
        # on CUDA a replay: its outputs are valid until the next prefill
        logits, caches = self._prefill(self.params, batch)
        if self._kv is not None:
            # A fresh coded store per request: ingest the prefill slots,
            # then serve every step from decoded reads, so the logits go
            # through the encode → decode round trip.
            self._kv = self._make_kvstore()
            self._kv.ingest(caches)
            caches = self._kv.read(caches)
        prompt_len = tokens.shape[1] + (0 if prefix_embeds is None
                                        else batch["prefix_embeds"].shape[1])
        tok = self._sample(logits)
        out = [tok]
        totals: Dict[str, float] = {}
        self.step_metrics = []
        self.epoch_specs = ({} if self._spec is None
                            else {self._spec.book_epoch: self._spec})
        for i in range(max_new_tokens - 1):
            t0 = time.perf_counter()
            # on CUDA a replay: the token, the position and (in the first
            # step, or from a coded store's read) the caches are copied
            # into the graph's buffers on the device
            logits, caches, m = self._step(self.params, tok, caches,
                                           prompt_len + i)
            if self._kv is not None:
                # outside the graph, as outside the reference's jit
                self._kv.ingest(caches)
                caches = self._kv.read(caches)
            tok = self._sample(logits)
            if self.lifecycle is None:          # only the lifecycle reads
                m = {k: v for k, v in m.items() if v.dim() == 0}
            rec = metrics_to_host(m)            # the step's one host sync
            rec["step_seconds"] = time.perf_counter() - t0
            self.step_metrics.append(rec)
            for k, v in rec.items():
                if not isinstance(v, float):           # per-plane histograms
                    if (self.lifecycle is not None
                            and k.startswith("act_hist_")):
                        self.lifecycle.observe(
                            (self._spec.tensor_kind, self._spec.scheme_name,
                             k[len("act_hist_"):]), v)
                elif k == "book_epoch":                # level, not a count
                    totals[k] = v
                elif k != "step_seconds":
                    totals[k] = totals.get(k, 0.0) + v
            if (self.lifecycle is not None and self.refresh_every > 0
                    and (i + 1) % self.refresh_every == 0
                    and self._maybe_refresh()):
                totals["book_refreshes"] = totals.get("book_refreshes",
                                                      0.0) + 1.0
            out.append(tok)
        for k in _SCALARS + ("act_shannon_bits", "book_epoch"):
            totals.setdefault(k, 0.0)          # stable for 1-token gens
        totals.update(self.hbm_stats())
        return torch.cat(out, dim=1).cpu().numpy(), totals

    def hbm_stats(self) -> Dict[str, float]:
        """Compressed-at-rest device-memory ledger (params + KV), reported
        next to the wire ledger in ``generate`` totals.  Zeros when the
        engine holds everything raw; ``hbm_effective_bandwidth_x`` is the
        raw/coded multiplier a memory-bound step gains by reading coded
        bytes."""
        stats = {"param_hbm_raw_bits": 0.0, "param_hbm_coded_bits": 0.0,
                 "kv_hbm_raw_bits": 0.0, "kv_hbm_coded_bits": 0.0}
        if self.param_store is not None:
            fp = self.param_store.footprint()
            stats["param_hbm_raw_bits"] = float(fp["hbm_raw_bits"])
            stats["param_hbm_coded_bits"] = float(fp["hbm_coded_bits"])
        if self._kv is not None:
            stats["kv_hbm_raw_bits"] = float(self._kv.kv_hbm_raw_bits)
            stats["kv_hbm_coded_bits"] = float(self._kv.kv_hbm_coded_bits)
        raw = stats["param_hbm_raw_bits"] + stats["kv_hbm_raw_bits"]
        coded = stats["param_hbm_coded_bits"] + stats["kv_hbm_coded_bits"]
        stats["hbm_raw_bits"] = raw
        stats["hbm_coded_bits"] = coded
        stats["hbm_effective_bandwidth_x"] = (raw / coded) if coded else 0.0
        return stats
