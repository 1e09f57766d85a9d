"""Port parity: the compiled prefill.

On CUDA ``serve.Engine`` runs ``prefill`` as a ``serve.CapturedPrefill``
(the reference's ``jax.jit(partial(prefill, cfg=..., cache_len=...))``):
captured once as a CUDA graph for each request shape, every graph of an
engine recording into the first one's memory pool, and replayed for
every later request of that shape.  Here, on the CPU, where no graph can
be recorded:

* on the ``meta`` device, where ``.item()``, ``bool()`` or a copy to the
  host raises, ``prefill`` runs to the end for every block kind's tiny
  config of ``test_torch_decode_pos.py`` (with and without a prefix) and
  for the six served configs at full width, each block group cut to one
  repeat, ``internvl2-26b`` after its 1024-patch prefix; its caches have
  the shapes and dtypes of ``init_caches``, the decode graph's buffers;
* ``CapturedPrefill`` with a stand-in for ``capture.Capture`` whose
  replay re-runs the recorded function (``_torch_capture._CPUCapture``)
  gives the eager prefill's logits and every cache leaf (KV slots,
  positions, MoE counts, MLA latents, recurrent states) bit for bit for
  every block kind, with and without a prefix, and with a float8 cache;
  a second call of the same shape records nothing and follows its own
  inputs; a new shape makes a second graph in the first one's pool; its
  logits follow the reference's jitted prefill within 1e-4 (float32, as
  ``test_torch_serve.py`` holds the eager prefill), positions equal;
* ``Engine``'s epoch flips release the decode step and keep the prefill
  graphs, as the reference keeps its ``_prefill``.
"""
import functools
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import BlockGroup as RefGroup  # noqa: E402
from repro.models import ModelConfig as RefConfig  # noqa: E402
from repro.models import prefill as ref_prefill  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.lifecycle import (BookLifecycleManager,  # noqa: E402
                                   DriftThresholds)
from repro_torch.models import (BlockGroup, ModelConfig,  # noqa: E402
                                init_caches, model_init, prefill)
from repro_torch.models.blocks import BLOCK_KINDS  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402

from _torch_capture import _CPUCapture  # noqa: E402
from test_torch_decode_pos import _kw  # noqa: E402

torch.set_num_threads(1)

HEAD, SHORT, PREFIX, CACHE = 6, 4, 3, 16   # prompt, shorter prompt, slots
SERVED = ("gemma2-2b", "llama4-scout-17b-a16e", "deepseek-v3-671b",
          "recurrentgemma-9b", "mamba2-780m", "internvl2-26b")
TOL = dict(rtol=1e-4, atol=1e-4)


def _tiny(kind, **kw):
    return ModelConfig(name="t", arch_type="x",
                       blocks=(BlockGroup((kind,), 2),), dtype=torch.float32,
                       **dict(_kw(kind), **kw))


@functools.lru_cache(maxsize=None)
def _model(kind, kv_cache_dtype=None):
    cfg = _tiny(kind, kv_cache_dtype=kv_cache_dtype)
    return cfg, model_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


def _batch(cfg, seed, seq=HEAD, prefix=False, device="cpu"):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, seq))).to(device)}
    if prefix:
        batch["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, PREFIX, cfg.d_model), dtype=np.float32)).to(device)
    return batch


def _bits_equal(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _same_as_eager(got, params, batch, cfg):
    """The captured call's (logits, caches) against the eager prefill on
    copies of its inputs, bit for bit; returns the eager logits."""
    want = prefill(params, {k: v.clone() for k, v in batch.items()}, cfg,
                   CACHE)
    assert _bits_equal(got[0], want[0])
    got_leaves, want_leaves = tree_leaves(got[1]), tree_leaves(want[1])
    assert len(got_leaves) == len(want_leaves)
    for j, (a, b) in enumerate(zip(got_leaves, want_leaves)):
        assert _bits_equal(a, b), j
    return want[0]


@pytest.fixture
def cpu_capture(monkeypatch):
    _CPUCapture.made = []
    monkeypatch.setattr(serve_engine, "Capture", _CPUCapture)
    return _CPUCapture


def _captured(cfg):
    return serve_engine.CapturedPrefill(
        functools.partial(prefill, cfg=cfg, cache_len=CACHE))


# ------------------------------------------------ (a) prefill on meta
def _meta_prefill(cfg, seq=HEAD, prefix=0, batch=2):
    params = model_init(cfg, None, device="meta")
    data = {"tokens": torch.zeros((batch, seq), dtype=torch.int64,
                                  device="meta")}
    if prefix:
        data["prefix_embeds"] = torch.zeros((batch, prefix, cfg.d_model),
                                            device="meta")
    cache_len = prefix + seq + 8
    logits, caches = prefill(params, data, cfg, cache_len)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (batch, seq, cfg.vocab_size)
    want = tree_leaves(init_caches(cfg, batch, cache_len, device="meta"))
    got = tree_leaves(caches)
    assert [(a.shape, a.dtype) for a in got] == [(b.shape, b.dtype)
                                                 for b in want]
    assert all(a.device.type == "meta" for a in got)


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_prefill_reads_nothing_back_on_meta(kind):
    """Every op of the prefill runs on meta tensors, where ``.item()``,
    ``bool()`` or a copy to the host raises: nothing in it stops a graph
    capture (a copy from the host does not raise there: the card's
    capture finds those)."""
    cfg = _tiny(kind)
    _meta_prefill(cfg)
    _meta_prefill(cfg, prefix=PREFIX)


@pytest.mark.parametrize("arch", SERVED)
def test_full_width_prefill_on_meta(arch):
    """The six configs ``chip_smoke.py`` serves, at full width on meta,
    each block group's depth cut to one repeat; ``internvl2-26b`` after
    its 1024-patch prefix."""
    cfg = get_config(arch)
    _meta_prefill(replace(cfg, blocks=tuple(replace(bg, repeats=1)
                                            for bg in cfg.blocks)),
                  seq=64, prefix=cfg.prefix_len)


# ------------------------- (b, c, d) the captured form against eager
@pytest.mark.parametrize("prefix", [False, True], ids=["tokens", "prefix"])
@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_captured_prefill_equals_eager_bit_for_bit(kind, prefix,
                                                   cpu_capture):
    """The first call warms up, records and replays; its outputs are
    the eager prefill's; a second call of the shape records nothing new
    and gives the eager prefill of its own inputs, not the first's."""
    cfg, params = _model(kind)
    cap = _captured(cfg)
    first = _batch(cfg, 1, prefix=prefix)
    want1 = _same_as_eager(cap(params, first), params, first, cfg)
    second = _batch(cfg, 2, prefix=prefix)
    got = cap(params, second)
    want2 = _same_as_eager(got, params, second, cfg)
    assert not _bits_equal(want2, want1)
    assert len(cpu_capture.made) == 1 and len(cap._graphs) == 1
    assert cpu_capture.made[0].replays == 2
    (g,) = cap._graphs.values()
    assert got[0] is g.outputs["logits"]          # the graph's buffers


@pytest.mark.parametrize("kind", ["attn", "mla"])
def test_captured_prefill_float8_cache(kind, cpu_capture):
    """A float8 KV cache (written through its uint8 view) bit for bit."""
    cfg, params = _model(kind, torch.float8_e4m3fn)
    batch = _batch(cfg, 3, prefix=True)
    _same_as_eager(_captured(cfg)(params, batch), params, batch, cfg)


@pytest.mark.parametrize("kind", ["local_moe", "mla_moe", "rec", "mamba"])
def test_new_shape_makes_second_graph_in_one_pool(kind, cpu_capture):
    """A shorter prompt is another graph, recorded into the first
    graph's pool; the first shape's graph then still gives the eager
    prefill of new inputs, and a new parameter tree is another graph."""
    cfg, params = _model(kind)
    cap = _captured(cfg)
    for seed, seq in ((4, HEAD), (5, SHORT), (6, HEAD)):
        batch = _batch(cfg, seed, seq=seq)
        _same_as_eager(cap(params, batch), params, batch, cfg)
    made = cpu_capture.made
    assert len(cap._graphs) == len(made) == 2
    assert made[1].pool is made[0].pool is not None
    assert [c.replays for c in made] == [2, 1]
    other = tree_map(torch.clone, params)
    cap(other, _batch(cfg, 7))
    assert len(cap._graphs) == 3 and made[2].pool is made[0].pool
    cap.release()
    assert not cap._graphs
    cap(params, _batch(cfg, 8))
    assert made[3].pool is not made[0].pool        # released: a new pool


def test_captured_prefill_follows_reference_jit(cpu_capture):
    """A windowed cache's ring after a prefix, through the captured
    form, against the reference's jitted prefill: logits and K/V within
    ``TOL``, positions equal."""
    kind = "local"
    cfg, params = _model(kind)
    rcfg = RefConfig(name="t", arch_type="x", blocks=(RefGroup((kind,), 2),),
                     dtype=jnp.float32, **_kw(kind))
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    batch = _batch(cfg, 9, prefix=True)
    logits, caches = _captured(cfg)(params, batch)
    want, rcaches = jax.jit(ref_prefill, static_argnums=(2, 3))(
        rparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
        rcfg, CACHE)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    leaves = tree_leaves(caches)
    assert len(leaves) == len(jax.tree.leaves(rcaches))
    for a, b in zip(leaves, jax.tree.leaves(rcaches)):
        if a.dtype == torch.int32:                    # positions
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# -------------------------------------- (e) the engine across a flip
def test_engine_epoch_flip_keeps_the_prefill_graphs(monkeypatch,
                                                    cpu_capture):
    """Under a lifecycle manager whose books go stale every window, the
    engine releases each superseded decode step and never its prefill:
    one graph of the request's shape, replayed by every ``generate``,
    whose tokens are the plain prefill's."""
    released = []
    monkeypatch.setattr(serve_engine.CapturedPrefill, "release",
                        lambda self: released.append(self))
    real = serve_engine.release
    monkeypatch.setattr(serve_engine, "release",
                        lambda step: (released.append(step), real(step)))
    cfg, params = _model("attn")
    stale = DriftThresholds(kl_bits=0.0, excess_bits=0.0, min_symbols=1,
                            patience=1)
    tok = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, 4))

    def engine(captured):
        mgr = BookLifecycleManager(thresholds=stale)
        for p in ("lo", "hi"):
            mgr.install(("act", "bf16", p), np.ones(256, dtype=np.int64))
        eng = serve_engine.Engine(
            params, cfg, serve_engine.ServeConfig(max_cache_len=CACHE),
            mgr.spec("act", "bf16"), lifecycle=mgr, refresh_every=2,
            device="cpu")
        assert isinstance(eng._prefill, functools.partial)    # the CPU's
        if captured:
            eng._prefill = serve_engine.CapturedPrefill(eng._prefill)
        return eng

    plain, eng = engine(False), engine(True)
    want, _ = plain.generate(tok, 6)
    released.clear()
    got, totals = eng.generate(tok, 6)
    got2, totals2 = eng.generate(tok, 6)
    assert (got == want).all() and (got2 == want).all()
    assert totals["book_refreshes"] == totals2["book_refreshes"] == 2
    assert len(released) == 4 and eng._prefill not in released
    assert len(eng._prefill._graphs) == 1
    assert [c.replays for c in cpu_capture.made] == [2]
