"""Port parity, train slice: ``repro_torch.optim``, ``data``,
``train.step`` and ``launch.train`` against the JAX reference on the
CPU.

The model is ``gemma2-2b``'s ``reduced()`` variant (one ``attn`` layer,
d 256, vocab 512, bf16) with seeded weights held as one numpy tree (the
port's ``model_init`` draws them: the reference's jitted init costs
seconds of compile), given to the reference as arrays and to the port
through ``models.convert.from_jax_params``.  Batches are the
reference's ``SyntheticDataset`` draws.  The reference's train step and
gradient are jitted once per module (a fixture).

Tolerances: the optimizer and the gradient probe on the *same* inputs
are held to float32 rounding (the probe's histograms and bits exactly);
a whole bf16 step is held to ``train.step.STEP_TOL``, since the two
frameworks round their bf16 products and gradients in other orders.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import (DataConfig as RefData,  # noqa: E402
                        SyntheticDataset as RefDataset)
from repro.launch.train import (  # noqa: E402
    bootstrap_codebooks as ref_bootstrap)
from repro.lifecycle import BookLifecycleManager as RefManager  # noqa: E402
from repro.models import forward_train as ref_forward  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import step as ref_step  # noqa: E402

from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticDataset  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.lifecycle import BookLifecycleManager  # noqa: E402
from repro_torch.models import (BlockGroup, forward_train,  # noqa: E402
                                model_init)
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_jax_params, tensor_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

TOL = tstep.STEP_TOL
F32 = dict(rtol=1e-6, atol=0.0)
LR = 1e-3
RCFG = ref_get_config("gemma2-2b").reduced()
TCFG = get_config("gemma2-2b").reduced()
DP = 4


def _np(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _batch(seed=0, n=1, batch=4, seq=32):
    ds = RefDataset(RCFG, RefData(batch, seq, seed=seed))
    return [next(ds) for _ in range(n)]


@pytest.fixture(scope="module")
def ref():
    """The reference's params, one batch, its gradient at the params with
    its probe of that gradient under the bootstrap books, and one train
    step (the ZeRO legs on a DP-way ring) under those books."""
    gen = torch.Generator().manual_seed(0)
    np_params = tree_map(_np, model_init(TCFG, gen, device="cpu"))
    params = jax.tree.map(jnp.asarray, np_params)
    (batch,) = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = ref_step.train_state_init(params)
    mgr = RefManager()
    ref_bootstrap(state, mgr)
    spec = mgr.spec("grad", "bf16", mode="ledger")

    def loss(p, b):
        logits, aux = ref_forward(p, b, RCFG)
        return ref_step.cross_entropy_loss(logits, b["labels"]) + aux

    def grads_and_probe(p, b):
        lval, grads = jax.value_and_grad(loss)(p, b)
        return lval, grads, ref_step.grad_payload_stats(grads, spec)

    lval, grads, probe = jax.jit(grads_and_probe)(params, jb)
    step = jax.jit(ref_step.make_train_step(
        RCFG, ref_adamw.AdamWConfig(lr=LR), comp_spec=spec, dp_degree=DP,
        grad_sync="reduce_scatter"))
    new_state, metrics = step(state, jb)
    return {"params": np_params, "batch": batch,
            "loss": float(lval), "grads": jax.device_get(grads),
            "probe": jax.device_get(probe), "state": state, "mgr": mgr,
            "spec": spec,
            "new_state": jax.device_get(new_state),
            "metrics": jax.device_get(metrics)}


def _tparams(ref):
    return from_jax_params(ref["params"], TCFG, device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _tspec(mgr, spec):
    return mgr.spec(spec.tensor_kind, spec.scheme_name, mode=spec.mode)


# ------------------------------------------------------------- data, trees
def test_synthetic_dataset_batches_equal_reference():
    for seed in (0, 3):
        ds = SyntheticDataset(TCFG, DataConfig(4, 32, seed=seed))
        for want in _batch(seed, n=3):
            got = next(ds)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_tree_leaves_in_reference_order(ref):
    tp = _tparams(ref)
    rl = jax.tree.leaves(ref["params"])
    tl = tree_leaves(tp)
    assert len(rl) == len(tl) > 8
    for r, t in zip(rl, tl):
        assert tuple(r.shape) == tuple(t.shape)
        np.testing.assert_array_equal(_f32(r), _f32(_np(t)))


def test_bootstrap_codebooks_give_the_reference_books(ref):
    tp = _tparams(ref)
    rm, tm = ref["mgr"], BookLifecycleManager()
    launch_train.bootstrap_codebooks(tstep.train_state_init(tp), tm)
    assert tm.book_epoch == rm.book_epoch == 2
    assert tm.snapshot.content_hash == rm.snapshot.content_hash
    for plane in ("lo", "hi"):
        np.testing.assert_array_equal(tm.books("grad")[plane].lengths,
                                      rm.books("grad")[plane].lengths)
    assert _tspec(tm, ref["spec"]) == CompressionSpec.from_registry(
        tm.snapshot, "grad", "bf16")


# --------------------------------------------------------------- optimizer
def _tree(seed):
    """A seeded numpy param/grad tree with bf16 and float32 leaves."""
    rng = np.random.default_rng(seed)
    return {"b": {"w": (rng.standard_normal((6, 5)) * 0.3).astype(
                ml_dtypes.bfloat16),
                  "s": rng.standard_normal(7).astype(np.float32)},
            "a": (rng.standard_normal((3, 4)) * 2).astype(
                ml_dtypes.bfloat16)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: tensor_from_numpy(a, "cpu"), tree)


def test_cosine_schedule_equals_reference():
    steps = np.arange(0, 14, dtype=np.int32)
    for warmup, total in ((1, 8), (3, 12), (0, 1)):
        rf = ref_adamw.cosine_schedule(LR, warmup, total)
        tf = adamw.cosine_schedule(LR, warmup, total)
        got = tf(torch.from_numpy(steps)).numpy()
        want = np.asarray(jax.jit(rf)(jnp.asarray(steps)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [1.0, 0.3])
def test_adamw_update_equals_reference(clip):
    cfg_r = ref_adamw.AdamWConfig(lr=2e-2, grad_clip=clip)
    cfg_t = adamw.AdamWConfig(lr=2e-2, grad_clip=clip)
    params = _tree(0)
    st_r = ref_adamw.adamw_init(jax.tree.map(jnp.asarray, params))
    tp = _torch_tree(params)
    st_t = adamw.adamw_init(tp)
    pr = jax.tree.map(jnp.asarray, params)
    given = tree_leaves(tp)
    first = [t.clone() for t in given]
    ref_update = jax.jit(ref_adamw.adamw_update, static_argnums=3)
    for i in range(3):                      # three steps: bias corrections
        grads = _tree(10 + i)
        scale = 0.5 + 0.25 * i
        pr, st_r, mr = ref_update(
            jax.tree.map(jnp.asarray, grads), st_r, pr, cfg_r,
            jnp.float32(scale))
        before = st_t
        tp, st_t, mt = adamw.adamw_update(_torch_tree(grads), st_t, tp,
                                          cfg_t, torch.tensor(scale))
        # the update consumes its state: the moments moved in place
        assert all(a is b for a, b in zip(
            tree_leaves(st_t.m) + tree_leaves(st_t.v),
            tree_leaves(before.m) + tree_leaves(before.v)))
        assert int(before.step) == i
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mr["grad_norm"]), **F32)
        np.testing.assert_allclose(float(mt["lr"]), float(mr["lr"]), **F32)
        assert int(st_t.step) == int(st_r.step) == i + 1
        for r, t in zip(jax.tree.leaves(st_r.m) + jax.tree.leaves(st_r.v),
                        tree_leaves(st_t.m) + tree_leaves(st_t.v)):
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-9)
        for r, t in zip(jax.tree.leaves(pr), tree_leaves(tp)):
            assert t.dtype == (torch.bfloat16 if r.dtype == jnp.bfloat16
                               else torch.float32)
            # one rounding step of the leaf's dtype at most
            ulp = 2.0 ** -7 if t.dtype == torch.bfloat16 else 2.0 ** -22
            np.testing.assert_allclose(_f32(_np(t)), _f32(r), rtol=ulp,
                                       atol=1e-7)
        if i == 0:                          # the input params stay as is
            assert all(torch.equal(a, b) for a, b in zip(first, given))
    assert float(adamw.global_norm(_torch_tree(params))) == pytest.approx(
        float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, params))),
        rel=1e-6)


# ----------------------------------------------------------------- loss
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_equals_reference(masked):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 6, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 6)).astype(np.int32)
    mask = ((rng.random((2, 6)) > 0.3).astype(np.float32) if masked
            else None)
    want = ref_step.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = tstep.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), **F32)


# ------------------------------------------------------------ grad probe
def test_grad_payload_stats_on_the_reference_gradients(ref):
    """The same gradient tree through both probes: histograms and bits
    equal (B5's plain version against ``histogram256_xla``), Shannon
    bits at float32 rounding (float64 in the port)."""
    tm = BookLifecycleManager()
    launch_train.bootstrap_codebooks(
        tstep.train_state_init(_tparams(ref)), tm)
    tspec = _tspec(tm, ref["spec"])
    grads_t = jax.tree.map(lambda a: tensor_from_numpy(a, "cpu"),
                           ref["grads"])
    got = tstep.grad_payload_stats(grads_t, tspec)
    want = ref["probe"]
    assert set(got) == set(want)
    for plane in ("lo", "hi"):
        np.testing.assert_array_equal(got[f"hist_{plane}"].numpy(),
                                      np.asarray(want[f"hist_{plane}"]))
    for k in ("raw_bits", "coded_bits"):
        assert float(got[k]) == float(want[k]) > 0, k
    np.testing.assert_allclose(float(got["shannon_bits"]),
                               float(want["shannon_bits"]), rtol=1e-6)
    off = tstep.grad_payload_stats(grads_t, None)
    assert set(off) == {"raw_bits", "coded_bits", "shannon_bits"}
    assert all(float(v) == 0.0 for v in off.values())


# ------------------------------------------------------------ train step
def _port_step(ref, **kw):
    tp = _tparams(ref)
    mgr = BookLifecycleManager()
    state = tstep.train_state_init(tp)
    launch_train.bootstrap_codebooks(state, mgr)
    spec = _tspec(mgr, ref["spec"])
    step = tstep.make_train_step(TCFG, adamw.AdamWConfig(lr=LR),
                                 comp_spec=spec, **kw)
    return step(state, _tbatch(ref["batch"]))


def _within_tol(got, want, lr=None):
    """Every reading of ``train.step.step_deviation`` within the limit
    of its name in ``STEP_TOL`` (the readings print under ``pytest -s``:
    the limits are set from them)."""
    dev = tstep.step_deviation(got, want, lr)
    print("step_deviation", dev)
    assert dev and all(v <= TOL[k] for k, v in dev.items()), dev
    return dev


def test_train_step_equals_reference(ref):
    new, m = _port_step(ref, dp_degree=DP, grad_sync="reduce_scatter")
    rm = ref["metrics"]
    assert set(m) == set(rm)
    keys = ("loss", "ce", "grad_norm")
    dev = _within_tol(
        {**{k: m[k] for k in keys}, "m": new.opt.m, "params": new.params},
        {**{k: rm[k] for k in keys}, "m": ref["new_state"].opt.m,
         "params": ref["new_state"].params}, LR)
    assert set(dev) == {"loss", "grad_norm", "grads", "param_steps",
                        "param_flips"}
    assert float(m["lr"]) == float(rm["lr"]) == pytest.approx(LR)
    assert float(m["aux"]) == float(rm["aux"]) == 0.0
    assert float(m["book_epoch"]) == float(rm["book_epoch"]) == 2.0
    raw = float(m["grad_raw_bits"])
    assert raw == float(rm["grad_raw_bits"]) == 16 * sum(
        t.numel() for t in tree_leaves(new.params))
    # the ZeRO legs: factors equal to the reference's, bit for bit
    for k in ("grad_wire_raw_bits", "grad_wire_rs_raw_bits",
              "grad_wire_ag_raw_bits"):
        assert float(m[k]) / raw == float(rm[k]) / float(
            rm["grad_raw_bits"]), k
    for leg in ("rs", "ag"):
        assert float(m[f"grad_wire_{leg}_coded_bits"]) == pytest.approx(
            0.75 * float(m["grad_coded_bits"]), rel=1e-12)


def test_gradients_equal_reference_at_bf16_tolerance(ref):
    loss, _, grads = tstep.loss_and_grads(_tparams(ref), _tbatch(ref["batch"]),
                                          TCFG)
    for r, t in zip(jax.tree.leaves(ref["grads"]), tree_leaves(grads)):
        assert t.dtype == (torch.bfloat16 if r.dtype == jnp.bfloat16
                           else torch.float32)
    _within_tol({"loss": loss, "grads": grads},
                {"loss": ref["loss"], "grads": ref["grads"]})


def test_grad_accum_2_agrees_with_1(ref):
    tp, tb = _tparams(ref), _tbatch(ref["batch"])
    l1, (ce1, _, _), g1 = tstep.loss_and_grads(tp, tb, TCFG)
    l2, (ce2, _, _), g2 = tstep.loss_and_grads(tp, tb, TCFG, grad_accum=2)
    assert all(b.dtype == torch.float32 for b in tree_leaves(g2))
    _within_tol({"loss": l2, "ce": ce2, "grads": g2},
                {"loss": l1, "ce": ce1, "grads": g1})
    step2 = tstep.make_train_step(TCFG, adamw.AdamWConfig(lr=LR),
                                  grad_accum=2)
    new, m = step2(tstep.train_state_init(tp), tb)
    _within_tol({"loss": m["loss"], "params": new.params},
                {"loss": l1, "params": ref["new_state"].params}, LR)


def test_hierarchical_wire_factors_equal_reference(ref):
    """dp_axis_sizes on a two-axis ring: the total and the per-axis
    split, against the reference's own factor functions."""
    from repro.comm.hierarchy import hierarchical_wire_factor
    tp = _tparams(ref)
    mgr = BookLifecycleManager()
    state = tstep.train_state_init(tp)
    launch_train.bootstrap_codebooks(state, mgr)
    spec = mgr.spec("grad", "bf16", mode="ledger", transport="ring",
                    axes=("dp_in", "dp_out"))
    step = tstep.make_train_step(TCFG, adamw.AdamWConfig(lr=LR),
                                 comp_spec=spec, dp_degree=8,
                                 dp_axis_sizes=(4, 2))
    _, m = step(state, _tbatch(ref["batch"]))
    raw = float(m["grad_raw_bits"])
    f = float(np.float32(hierarchical_wire_factor(4, 2)))
    assert float(m["grad_wire_raw_bits"]) / raw == f
    assert float(m["grad_wire_inner_raw_bits"]) / raw == 2 * 3 / 4
    assert float(m["grad_wire_outer_raw_bits"]) / raw == 2 * 1 / 8
    assert {k for k in m if k.startswith("grad_wire")} == {
        f"grad_wire_{a}{w}_bits" for a in ("", "inner_", "outer_")
        for w in ("raw", "coded")}


def test_refusals_match_reference():
    cases = ({"grad_sync": "ring-of-fire"},
             {"dp_degree": 8, "dp_axis_sizes": (2, 2)},
             {"dp_degree": 8, "dp_axis_sizes": (4, 2),
              "grad_sync": "reduce_scatter"})
    for kw in cases:
        with pytest.raises(ValueError) as want:
            ref_step.make_train_step(RCFG, ref_adamw.AdamWConfig(), **kw)
        with pytest.raises(ValueError) as got:
            tstep.make_train_step(TCFG, adamw.AdamWConfig(), **kw)
        assert str(got.value) == str(want.value)
    # the recurrent kinds train (a mamba block has no FFN); an unknown
    # kind refuses inside the train forward
    batch = {"tokens": torch.zeros(1, 2, dtype=torch.int64),
             "labels": torch.zeros(1, 2, dtype=torch.int64)}
    mamba = dataclasses.replace(TCFG, blocks=(BlockGroup(("mamba",), 1),),
                                ssm_state=16, ssm_head_dim=32)
    params = model_init(mamba, torch.Generator().manual_seed(0),
                        device="cpu")
    assert set(params["groups"][0][0]) == {"norm_mix", "mixer"}
    loss, _, grads = tstep.loss_and_grads(params, batch, mamba)
    assert bool(torch.isfinite(loss))
    assert [g.shape for g in tree_leaves(grads)] == [
        p.shape for p in tree_leaves(params)]
    # a leaf the forward never reads is a fault, and autograd says so
    stray = dict(params, embed=dict(params["embed"],
                                    stray=torch.zeros(2)))
    with pytest.raises(RuntimeError, match="not have been used"):
        tstep.loss_and_grads(stray, batch, mamba)
    bare = {"embed": {"table": torch.zeros(TCFG.vocab_size, TCFG.d_model)},
            "groups": (({},),)}
    odd = dataclasses.replace(TCFG, blocks=(BlockGroup(("ssm4",), 1),))
    with pytest.raises(ValueError, match="unknown block kind"):
        tstep.loss_and_grads(bare, batch, odd)
    # prefix embeddings train: logits over the token positions only; a
    # prefix-only batch never reads the token table, whose gradient is 0
    d = mamba.d_model
    vlm = dict(batch, prefix_embeds=torch.randn(1, 3, d))
    logits, _ = forward_train(params, vlm, mamba)
    assert logits.shape == (1, 2, mamba.vocab_size)
    audio = {"prefix_embeds": torch.randn(1, 2, d), "labels": batch["labels"]}
    enc = dataclasses.replace(mamba, prefix_only=True, tie_embeddings=False)
    loss, _, grads = tstep.loss_and_grads(
        model_init(enc, torch.Generator().manual_seed(0), device="cpu"),
        audio, enc)
    assert bool(torch.isfinite(loss))
    assert not grads["embed"]["table"].any()


def test_moe_wire_raw_bits_equal_reference():
    """``make_train_step(ep_degree=4)`` on reduced llama4: the dispatch
    raw bits and their all-to-all wire share are the reference's
    (``repro.comm.transport``'s formula and factor, in float32 as its
    step computes them), and per token ``moe_ep_raw_bits``, the helper
    the serve step reports through."""
    from repro.comm.transport import RING_FACTORS as ref_factors
    from repro.comm.transport import moe_dispatch_raw_bits as ref_dispatch

    from repro_torch.configs import get_config
    from repro_torch.core.codebook import build_codebook
    from repro_torch.comm.transport import moe_ep_raw_bits

    cfg = get_config("llama4-scout-17b-a16e").reduced()
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    book = build_codebook(np.ones(256))
    spec = CompressionSpec.from_books({"lo": book, "hi": book}, "bf16",
                                      tensor_kind="grad")
    tok = torch.zeros((2, 8), dtype=torch.int64)
    for ep in (4, 1):
        step = tstep.make_train_step(cfg, adamw.AdamWConfig(),
                                     comp_spec=spec, ep_degree=ep)
        _, m = step(tstep.train_state_init(params),
                    {"tokens": tok, "labels": tok})
        dispatch = np.float32(ref_dispatch(16, 1, cfg.d_model, 16, 1))
        wire = np.float32(ref_factors["all_to_all"](4)) * dispatch
        if ep == 1:
            dispatch = wire = 0.0
        assert float(m["moe_dispatch_raw_bits"]) == float(dispatch)
        assert float(m["moe_wire_raw_bits"]) == float(wire)
        assert float(m["moe_wire_raw_bits"]) == 8 * moe_ep_raw_bits(
            cfg, 2, 16, ep)[1]


# -------------------------------------------------------------- launcher
def test_launch_train_main_runs_on_the_cpu(capsys):
    rec = launch_train.main(["--reduced", "--steps", "3", "--compress",
                             "--refresh-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] lifecycle:" in out
    steps = rec["steps"]
    assert len(steps) == 3
    assert all(np.isfinite(s["loss"]) for s in steps)
    mgr = rec["lifecycle"]
    # bootstrap books (epochs 1-2, from params) go stale on gradients
    assert mgr.n_refreshes >= 1 and mgr.book_epoch > 2
    epochs = {s["book_epoch"] for s in steps}
    assert mgr.n_recompiles == len(epochs) + (mgr.book_epoch not in epochs)
    assert all(s["grad_coded_bits"] > 0 for s in steps)
