"""Port parity: the compiled train step and the release of superseded
steps.

On CUDA the train loops run ``make_train_step``'s step as a
``train.CapturedTrainStep`` (the reference's ``jax.jit`` of the step):
the first call for a batch signature runs one eager step as the
warm-up and records the step on its result, whose tensors become the
graph's buffers; later calls copy the batch into static buffers and
replay, the graph writing the new params and step count back into the
state it reads.  Here, on the CPU, where no graph can be recorded:

* on the ``meta`` device, where ``.item()``, ``bool()`` or a copy to the
  host raises, the whole train step (forward, backward with block remat,
  the gradient probe under a spec, AdamW, the cosine schedule) runs to
  the end for every block kind's tiny config of
  ``test_torch_decode_pos.py`` and for ``gemma2-2b``, ``hubert-xlarge``
  and ``mamba2-780m`` at full width, each block group cut to one repeat:
  nothing in it stops a capture (B5 is the plain count there: the
  wrapper has no meta path);
* ``CapturedTrainStep`` with a stand-in for ``capture.Capture`` whose
  replay re-runs the recorded function (``_CPUCapture``) gives the eager
  step's losses, metrics, probe histograms, params, moments and step
  count bit for bit over 4 steps, across an epoch flip to a new spec,
  at ``grad_accum`` 1 and 2, and follows the reference's jitted step
  within ``STEP_TOL``;
* ``launch.train.train`` and ``serve.Engine`` release the superseded
  step on every epoch flip (stub steps record it), and a buffer of
  another shape or dtype is refused.
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import BlockGroup as RefGroup  # noqa: E402
from repro.models import ModelConfig as RefConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import step as ref_step  # noqa: E402

from repro_torch import capture  # noqa: E402
from repro_torch.comm import compression  # noqa: E402
from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.configs import get_config, train_grad_accum  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.data import DataConfig, SyntheticDataset  # noqa: E402
from repro_torch.kernels.histogram import histogram256_plain  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.lifecycle import (BookLifecycleManager,  # noqa: E402
                                   DriftThresholds)
from repro_torch.models import (BlockGroup, ModelConfig,  # noqa: E402
                                model_init)
from repro_torch.models.blocks import BLOCK_KINDS  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

from _torch_capture import _CPUCapture  # noqa: E402
from test_torch_decode_pos import _kw  # noqa: E402

torch.set_num_threads(1)

LR, STEPS, FLIP_AFTER = 1e-3, 4, 1      # the epoch flips after step 1
STALE = DriftThresholds(kl_bits=0.0, excess_bits=0.0, min_symbols=1,
                        patience=1)     # every window is stale


def _tiny(kind, n=2, dtype=torch.float32):
    return ModelConfig(name="t", arch_type="x",
                       blocks=(BlockGroup((kind,), n),), dtype=dtype,
                       **dict(_kw(kind), remat="block"))


def _uniform_spec():
    book = build_codebook(np.ones(256, dtype=np.int64))
    return CompressionSpec.from_books({"lo": book, "hi": book}, "bf16",
                                      tensor_kind="grad", mode="ledger")


def _batches(cfg, batch, seq, n, seed=0, device="cpu"):
    ds = SyntheticDataset(cfg, DataConfig(batch, seq, seed=seed))
    return [{k: torch.from_numpy(v).to(device) for k, v in next(ds).items()}
            for _ in range(n)]


def _bits_equal(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


# ------------------------------------------------ (a) the step on meta
def _meta_step(cfg, grad_accum=1, batch=2, seq=16):
    params = model_init(cfg, None, device="meta")
    state = tstep.train_state_init(params)
    step = tstep.make_train_step(cfg, AdamWConfig(lr=LR),
                                 cosine_schedule(LR, 1, 10),
                                 grad_accum=grad_accum,
                                 comp_spec=_uniform_spec())
    (data,) = _batches(cfg, batch, seq, 1, device="meta")
    new, metrics = step(state, data)
    assert all(t.device.type == "meta" for t in tree_leaves(new))
    assert {"loss", "grad_norm", "lr", "grad_coded_bits", "grad_hist_lo",
            "grad_hist_hi"} <= set(metrics)
    assert tuple(metrics["grad_hist_hi"].shape) == (256,)


@pytest.fixture
def meta_b5(monkeypatch):
    """B5's wrapper refuses meta tensors: the probe counts with the plain
    version there, as it does on the CPU."""
    monkeypatch.setattr(compression, "histogram256", histogram256_plain)


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_train_step_reads_nothing_back_on_meta(kind, meta_b5):
    _meta_step(_tiny(kind))


@pytest.mark.parametrize("arch", ["gemma2-2b", "hubert-xlarge",
                                  "mamba2-780m"])
def test_full_width_train_step_on_meta(arch, meta_b5):
    cfg = get_config(arch)
    assert cfg.remat == "block"
    _meta_step(replace(cfg, blocks=tuple(replace(bg, repeats=1)
                                         for bg in cfg.blocks)),
               grad_accum=train_grad_accum(arch))


# ------------------------- (b) the captured form against the eager step
@pytest.fixture
def cpu_capture(monkeypatch):
    _CPUCapture.made = []
    monkeypatch.setattr(tstep, "Capture", _CPUCapture)
    return _CPUCapture


def _run(cfg, params, batches, captured, grad_accum):
    """``STEPS`` steps from ``params`` (not modified) with the books
    bootstrapped from them and an epoch flip after step ``FLIP_AFTER``:
    (each step's metrics, cloned; the final state; the steps built)."""
    state = tstep.train_state_init(params)
    mgr = BookLifecycleManager(thresholds=STALE)
    launch_train.bootstrap_codebooks(state, mgr)
    sched = cosine_schedule(LR, warmup=1, total=STEPS)
    built = []

    def build(m):
        step = tstep.make_train_step(cfg, AdamWConfig(lr=LR), sched,
                                     grad_accum=grad_accum,
                                     comp_spec=m.spec("grad", "bf16"))
        built.append(tstep.CapturedTrainStep(step) if captured else step)
        return built[-1]

    step_fn = mgr.compiled("train_step", build)
    out = []
    for i, batch in enumerate(batches):
        state, m = step_fn(state, batch)
        out.append({k: v.clone() for k, v in m.items()})
        mgr.observe_train_metrics(m)
        if i == FLIP_AFTER:
            assert mgr.maybe_refresh() is not None
            capture.release(step_fn)
            step_fn = mgr.compiled("train_step", build)
    return out, state, built


@pytest.fixture(scope="module")
def tiny_gemma():
    cfg = get_config("gemma2-2b").reduced()
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, _batches(cfg, 4, 32, STEPS)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_captured_form_equals_eager_step_bit_for_bit(tiny_gemma, cpu_capture,
                                                     grad_accum):
    cfg, params, batches = tiny_gemma
    kept = tree_map(torch.clone, params)
    want, wstate, _ = _run(cfg, params, batches, False, grad_accum)
    got, gstate, built = _run(cfg, params, batches, True, grad_accum)
    for a, b in zip(tree_leaves(params), tree_leaves(kept)):
        assert _bits_equal(a, b)            # the caller's params untouched
    # epoch 1: a warm-up and one replay; epoch 2 (after the flip): a
    # warm-up and one replay; the first step released, the second not
    assert len(built) == 2 and [c.replays for c in cpu_capture.made] == [1, 1]
    assert not built[0]._graphs and len(built[1]._graphs) == 1
    assert want[-1]["book_epoch"] > want[0]["book_epoch"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert _bits_equal(g[k], w[k]), (i, k)
    for j, (a, b) in enumerate(zip(tree_leaves(gstate),
                                   tree_leaves(wstate))):
        assert _bits_equal(a, b), j     # params, step, m, v
    # the state a replay returns is the graph's own, written in place
    (g,) = built[1]._graphs.values()
    assert gstate is g.state and all(
        a is b for a, b in zip(tree_leaves(gstate), g.leaves))
    assert int(gstate.opt.step) == STEPS


def test_captured_form_replays_on_copies_of_new_inputs(tiny_gemma,
                                                       cpu_capture):
    """A state that is not the graph's own is copied into its buffers
    (its own moments are not moved); a batch of another shape is another
    signature, so another graph."""
    cfg, params, batches = tiny_gemma
    step = tstep.make_train_step(cfg, AdamWConfig(lr=LR))
    cap = tstep.CapturedTrainStep(step)
    state = tstep.train_state_init(params)
    state, _ = cap(state, batches[0])                 # warm-up, capture
    fresh = tstep.train_state_init(params)
    got_state, got = cap(fresh, batches[1])
    assert got_state is not fresh
    assert all(float(m.abs().max()) == 0.0 for m in tree_leaves(fresh.opt.m))
    want_state, want = step(tstep.train_state_init(params), batches[1])
    assert _bits_equal(got["loss"], want["loss"])
    for a, b in zip(tree_leaves(got_state.params),
                    tree_leaves(want_state.params)):
        assert _bits_equal(a, b)
    short = {k: v[:2] for k, v in batches[2].items()}
    cap(got_state, short)
    assert len(cap._graphs) == 2


def test_captured_form_follows_reference_jit(cpu_capture):
    """Float32 tiny model, the same params and batches: the captured form
    against the reference's ``jax.jit(make_train_step)`` over 4 steps,
    loss and grad norm within ``STEP_TOL`` and the params after each
    step within its params limits.  (The probe is held to the
    reference's in ``test_torch_train.py``, and to the eager step above;
    here it would double the reference's compile.)"""
    kw = dict(_kw("attn"), remat="none")     # remat: the tests above
    tcfg = replace(_tiny("attn"), remat="none")
    rcfg = RefConfig(name="t", arch_type="x", blocks=(RefGroup(("attn",), 2),),
                     dtype=jnp.float32, **kw)
    params = model_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    cap = tstep.CapturedTrainStep(tstep.make_train_step(
        tcfg, AdamWConfig(lr=LR)))
    ref = jax.jit(ref_step.make_train_step(rcfg,
                                           ref_adamw.AdamWConfig(lr=LR)))
    state = tstep.train_state_init(params)
    rstate = ref_step.train_state_init(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), params))
    for batch in _batches(tcfg, 2, 16, STEPS, seed=5):
        state, m = cap(state, batch)
        rstate, rm = ref(rstate, {k: jnp.asarray(v.numpy())
                                  for k, v in batch.items()})
        dev = tstep.step_deviation(
            {"loss": float(m["loss"]), "ce": float(m["ce"]),
             "grad_norm": float(m["grad_norm"]), "params": state.params},
            {"loss": float(rm["loss"]), "ce": float(rm["ce"]),
             "grad_norm": float(rm["grad_norm"]),
             "params": jax.device_get(rstate.params)}, LR)
        assert all(v <= tstep.STEP_TOL[k] for k, v in dev.items()), dev
    assert cpu_capture.made[0].replays == STEPS - 1


# ------------------------------------------- (c, d) release on a flip
class _Stub:
    """A step that records its calls and its release in ``log``."""

    def __init__(self, step, log):
        self.step, self.log, self.n = step, log, len(log)
        log.append(("built", id(self)))

    def __call__(self, *args):
        self.log.append(("call", id(self)))
        return self.step(*args)

    def release(self):
        self.log.append(("release", id(self)))


def _released_before_successor(log):
    """Each step built is released once, after its last call and before
    the next step's first call; returns the steps built."""
    built = [i for e, i in log if e == "built"]
    for a, b in zip(built, built[1:]):
        last_a = max(n for n, e in enumerate(log) if e == ("call", a))
        first_b = min([n for n, e in enumerate(log) if e == ("call", b)],
                      default=len(log))
        (rel,) = [n for n, e in enumerate(log) if e == ("release", a)]
        assert last_a < rel < first_b
    return built


def test_launch_train_releases_the_superseded_step(monkeypatch):
    log = []
    real = launch_train.make_train_step
    monkeypatch.setattr(launch_train, "make_train_step",
                        lambda *a, **k: _Stub(real(*a, **k), log))
    rec = launch_train.train(_tiny("attn", dtype=torch.bfloat16), steps=4,
                             batch_size=2, seq_len=16, compress=True,
                             refresh_every=1, device="cpu")
    built = _released_before_successor(log)
    assert len(rec["refreshes"]) >= 1
    assert len(built) == len(rec["refreshes"]) + 1
    assert log[-1] == ("release", built[-1])     # the run's end releases
    assert all("memory_allocated" not in r for r in rec["refreshes"])


def test_engine_releases_the_superseded_step(monkeypatch):
    log = []
    real = serve_engine.make_serve_step
    monkeypatch.setattr(serve_engine, "make_serve_step",
                        lambda *a, **k: _Stub(real(*a, **k), log))
    cfg = replace(_tiny("attn"), remat="none")
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mgr = BookLifecycleManager(thresholds=STALE)
    for p in ("lo", "hi"):
        mgr.install(("act", "bf16", p), np.ones(256, dtype=np.int64))
    eng = serve_engine.Engine(params, cfg,
                              serve_engine.ServeConfig(max_cache_len=16),
                              mgr.spec("act", "bf16"), lifecycle=mgr,
                              refresh_every=2, device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 4))
    _, totals = eng.generate(tok, 6)
    built = _released_before_successor(log)
    assert totals["book_refreshes"] == 2 and len(built) == 3
    assert ("release", built[-1]) not in log     # the engine keeps serving


# ---------------------------------------------------- (e) buffer guards
def test_buffers_refuse_another_shape_or_dtype():
    want = [torch.zeros(2, 3), torch.zeros(4, dtype=torch.int32)]
    capture.check_leaves([torch.ones(2, 3), torch.ones(4, dtype=torch.int32)],
                         want, "cache")
    with pytest.raises(ValueError, match=r"cache leaf 0 is \(3, 2\) "
                       r"float32, the captured step holds \(2, 3\) float32"):
        capture.check_leaves([torch.ones(3, 2), want[1]], want, "cache")
    with pytest.raises(ValueError, match=r"cache leaf 1 is \(4,\) int64"):
        capture.check_leaves([want[0], torch.ones(4, dtype=torch.int64)],
                             want, "cache")
    with pytest.raises(ValueError, match="1 cache leaves"):
        capture.check_leaves(want[:1], want, "cache")
    state = tstep.train_state_init({"w": torch.zeros(2, 3)})
    g = tstep._TrainGraph(None, state, {"x": torch.zeros(2)}, None)
    g.load(state, {"x": torch.ones(2)})
    assert float(g.batch["x"].sum()) == 2.0
    bad = tstep.train_state_init({"w": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match=r"state leaf 0 is \(3, 2\)"):
        g.load(bad, {"x": torch.ones(2)})
