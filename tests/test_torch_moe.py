"""Port parity, MoE slice: ``repro_torch.models.moe``, the ``attn_moe``
/ ``local_moe`` blocks, the MoE configs and the compressed
expert-parallel dispatch against the JAX reference on the CPU.

Weights are drawn by the port's ``model_init`` / ``moe_init`` (seeded),
held as one numpy tree, given to the reference as arrays and to the port
through ``models.convert`` (the reference's jitted inits cost seconds of
compile).  Routing is held *equal* (``topi`` and the dispatch counts) on
inputs whose float64 routing margins are checked to be far above
float32 rounding, so no tie decides a test; outputs are held at float32
tolerance.  The reference's ``moe_apply_a2a`` runs in this process under
``jax.vmap(..., axis_name=...)``, jitted once for both codecs; its
experts there get weights whose products are exact in both frameworks
(signed permutations, inputs in {-1, 0, 1}, silu at {-1, 0, 1}), so the
combine payload, and with it every hop's ``hop_coded_bits``, is the
reference's bit for bit.
"""
from dataclasses import fields, replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm.compression import CompressionSpec as RefSpec  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import train_grad_accum as ref_grad_accum  # noqa: E402
from repro.core.codebook import build_codebook as ref_build  # noqa: E402
from repro.models import forward_train as ref_forward  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.common import ModelConfig as RefConfig  # noqa: E402

from repro_torch.comm import LoopbackAxis, loopback_mesh  # noqa: E402
from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 train_grad_accum)
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.models import (BlockGroup, ModelConfig,  # noqa: E402
                                decode_step, forward, forward_train,
                                init_caches, model_init, prefill)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
MOE = dict(d_model=64, vocab_size=128, n_experts=4, experts_per_token=2,
           moe_d_ff=64)


def _np(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _cfgs(dtype="float32", **kw):
    """(reference cfg, port cfg) of one MoE layer; dtype by name."""
    rcfg = RefConfig(name="m", arch_type="moe", blocks=(),
                     dtype=getattr(jnp, dtype), **kw)
    tcfg = ModelConfig(name="m", arch_type="moe", blocks=(),
                       dtype=getattr(torch, dtype), **kw)
    return rcfg, tcfg


def _moe_params(tcfg, seed):
    """Seeded MoE layer params as a numpy tree and as port tensors."""
    gen = torch.Generator().manual_seed(seed)
    np_p = tree_map(_np, moe.moe_init(tcfg, gen, "cpu"))
    return np_p, tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_p)


def _margin(x, router, k):
    """The least float64 gap, over rows, between consecutive ranks of
    the top k+1 router probabilities (a gap below float32 rounding could
    let the frameworks pick or order experts differently)."""
    lg = np.asarray(x, np.float64).reshape(-1, router.shape[0]) @ router
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    return float(np.diff(-top, axis=-1).min())


# ------------------------------------------------------------- capacity
@pytest.mark.parametrize("e,k,cf", [(16, 1, 1.5), (4, 2, 1.25),
                                    (256, 8, 1.25), (8, 2, 1.0)])
def test_capacity_functions_equal_reference(e, k, cf):
    rcfg, tcfg = _cfgs(d_model=8, vocab_size=8, n_experts=e,
                       experts_per_token=k, capacity_factor=cf)
    n = np.arange(0, 1500)
    want = np.asarray(ref_moe.moe_stream_capacity(jnp.asarray(n), rcfg))
    got = moe.moe_stream_capacity(torch.from_numpy(n), tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (0, 1, 3, 17, 64, 80, 512, 1000, 4096, 32768, 524288):
        assert (moe.moe_stream_capacity_host(i, tcfg)
                == ref_moe.moe_stream_capacity_host(i, rcfg)
                == int(moe.moe_stream_capacity(i, tcfg)))
        assert moe.moe_capacity(i, tcfg) == ref_moe.moe_capacity(i, rcfg)


# -------------------------------------------------- forward, prefill, decode
_ref_prefill = jax.jit(ref_moe.moe_prefill, static_argnums=2)
_ref_decode = jax.jit(ref_moe.moe_decode, static_argnums=4)


def test_moe_prefill_and_decode_equal_reference():
    """Routing, counts and the drop decisions equal; y and aux at float32
    tolerance; ``moe_decode`` continues a prefill's counts token by token
    as the reference does, and drops what the full forward drops."""
    rcfg, tcfg = _cfgs(**MOE, n_shared_experts=1, capacity_factor=1.0)
    np_p, tp = _moe_params(tcfg, 0)
    rp = jax.tree.map(jnp.asarray, np_p)
    x = np.random.default_rng(4).normal(size=(3, 16, 64)).astype(np.float32)
    assert _margin(x, np_p["router"], 2) > 1e-5

    want_y, want_aux, want_counts = _ref_prefill(rp, jnp.asarray(x), rcfg)
    xt = torch.from_numpy(x)
    got_y, got_aux, got_counts = moe.moe_prefill(tp, xt, tcfg)
    assert got_counts.dtype == torch.int32
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)
    np.testing.assert_allclose(got_y.numpy(), want_y, **F32)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    _, topi, _ = moe._route(tp, xt.reshape(-1, 64), tcfg)
    _, rtopi, _ = ref_moe._route(rp, jnp.asarray(x.reshape(-1, 64)), rcfg)
    np.testing.assert_array_equal(topi.numpy(), rtopi)
    # the capacity drops slots at this size (the drop path runs)
    _, slot, _ = moe._dispatch(xt, topi.reshape(3, 16, 2), tcfg,
                               moe.moe_stream_capacity_host(16, tcfg))
    assert int((slot == 3 * 4 * moe.moe_stream_capacity_host(16, tcfg)
                ).sum()) > 0

    head = 10                     # both decodes start from the port's counts
    _, _, tc = moe.moe_prefill(tp, xt[:, :head], tcfg)
    rc = jnp.asarray(tc.numpy().copy())    # decode updates tc in place
    for t in range(head, 16):
        ry, rc = _ref_decode(rp, jnp.asarray(x[:, t:t + 1]), rc,
                             jnp.int32(t), rcfg)
        ty, tc2 = moe.moe_decode(tp, xt[:, t:t + 1], tc, t, tcfg)
        assert tc2 is tc                       # updated in place
        np.testing.assert_array_equal(tc.numpy(), rc)
        np.testing.assert_allclose(ty.numpy(), ry, **F32)
        np.testing.assert_allclose(ty[:, 0].numpy(), got_y[:, t].numpy(),
                                   **F32)
    np.testing.assert_array_equal(tc.numpy(), got_counts.numpy())


@pytest.mark.parametrize("kind,extra", [("attn_moe", {}),
                                        ("local_moe", {"sliding_window": 8,
                                                       "n_shared_experts": 1})])
def test_decode_matches_forward_and_prefill_handoff(kind, extra):
    """The reference's ``tests/test_models.py`` checks on the port's MoE
    blocks: decode from empty caches and a prefill hand-off both follow
    the full forward at rel < 1e-4 (float32), and the decode's routing
    counts end where a prefill of the whole sequence puts them."""
    cfg = ModelConfig(name="t", arch_type="moe", d_model=128,
                      vocab_size=256, blocks=(BlockGroup((kind,), 2),),
                      n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                      n_experts=4, experts_per_token=2, moe_d_ff=64,
                      remat="none", dtype=torch.float32, **extra)
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 12)))
    logits = forward(params, {"tokens": tok}, cfg)

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-9))

    caches = init_caches(cfg, 2, 32, device="cpu")
    outs = [decode_step(params, tok[:, t:t + 1], caches, t, cfg)[0]
            for t in range(12)]
    assert rel(torch.cat(outs, 1), logits) < 1e-4
    _, full = prefill(params, {"tokens": tok}, cfg, 32)
    for got, want in zip(tree_leaves(caches), tree_leaves(full)):
        if got.dtype == torch.int32 and got.dim() == 3:       # moe_counts
            assert torch.equal(got, want)

    lg, caches = prefill(params, {"tokens": tok[:, :6]}, cfg, 32)
    assert rel(lg, logits[:, :6]) < 1e-4
    for t in range(6, 12):
        lg, caches = decode_step(params, tok[:, t:t + 1], caches, t, cfg)
        assert rel(lg[:, 0], logits[:, t]) < 1e-4


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "qwen3-4b"])
def test_reduced_forward_equals_reference(arch):
    """The registered config's ``reduced()`` model (float32), params
    carried across by ``from_jax_params``: logits and aux at float32
    tolerance."""
    rcfg = ref_get_config(arch).reduced(dtype=jnp.float32)
    tcfg = get_config(arch).reduced(dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    np_params = tree_map(_np, model_init(tcfg, gen, device="cpu"))
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    tok = np.random.default_rng(2).integers(0, rcfg.vocab_size, (2, 16))
    want, waux = jax.jit(ref_forward, static_argnums=2)(
        jax.tree.map(jnp.asarray, np_params),
        {"tokens": jnp.asarray(tok, jnp.int32)}, rcfg)
    got, gaux = forward_train(tparams,
                                    {"tokens": torch.from_numpy(tok)}, tcfg)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5,
                               atol=1e-9)


# ----------------------------------------------------- compressed a2a
TP = 4


def _exact_params(rng, d, e, ff):
    """Experts whose products are exact in any summation order: signed
    permutations (the up one times 2, the down one times 1/2), so on
    inputs in {-1, 0, 1} the gate sees {-1, 0, 1} (where both packages'
    silu round alike) and every product holds one nonzero term."""
    def perm(rows, cols, scale):
        w = np.zeros((e, rows, cols), np.float32)
        for i in range(e):
            w[i, rng.permutation(rows)[:cols], np.arange(cols)] = (
                rng.choice([-1.0, 1.0], cols) * scale)
        return w.astype(ml_dtypes.bfloat16)

    return {"router": (rng.normal(size=(d, e)) * d ** -0.5
                       ).astype(np.float32),
            "w_gate": perm(d, ff, 1.0), "w_up": perm(d, ff, 2.0),
            "w_down": perm(ff, d, 0.5)}


@pytest.fixture(scope="module")
def a2a_case(gloo_world):
    """Inputs, books of both codecs, and the reference's moe_apply_a2a
    (y, hop_coded_bits) on a LoopbackAxis-shaped vmap of 4 ranks.  It
    asks for ``gloo_world`` so that the two gloo processes start before
    the reference compiles and run while it does."""
    rcfg, tcfg = _cfgs(**MOE, dtype="bfloat16")
    rng = np.random.default_rng(7)
    np_p = _exact_params(rng, 64, 4, 64)
    x = rng.integers(-1, 2, (TP, 2, 12, 64)).astype(ml_dtypes.bfloat16)
    assert _margin(x, np_p["router"], 2) > 1e-5
    u16 = x.view(np.uint16).reshape(-1)
    counts = {"lo": np.bincount(u16 & 0xFF, minlength=256) + 1,
              "hi": np.bincount(u16 >> 8, minlength=256) + 1}
    books = {c: ({p: ref_build(n, codec=c) for p, n in counts.items()},
                 {p: build_codebook(n, codec=c) for p, n in counts.items()})
             for c in ("huffman", "qlc")}
    rp = jax.tree.map(jnp.asarray, np_p)

    def both(xs):
        return {c: ref_moe.moe_apply_a2a(rp, xs, rcfg, "r", books[c][0],
                                         chunk=64, decode_backend="scan")
                for c in books}

    ref = jax.jit(jax.vmap(both, axis_name="r"))(jnp.asarray(x))
    return {"rcfg": rcfg, "tcfg": tcfg, "np_params": np_p, "x": x,
            "books": books, "ref": jax.device_get(ref)}


@pytest.mark.parametrize("codec", ["huffman", "qlc"])
def test_a2a_equals_scatter_and_reference_hop_bits(a2a_case, codec):
    c = a2a_case
    tcfg = c["tcfg"]
    tp = tree_map(lambda a: tensor_from_numpy(a, "cpu"), c["np_params"])
    x = tensor_from_numpy(c["x"], "cpu")
    y, aux, stats = moe.moe_apply_a2a(tp, x, tcfg, LoopbackAxis(TP),
                                      c["books"][codec][1], chunk=64,
                                      decode_backend="auto")
    y_sc, aux_sc = moe.moe_apply(tp, x.reshape(TP * 2, 12, 64), tcfg)
    assert torch.equal(_bits(y.reshape(y_sc.shape)), _bits(y_sc))
    ry, raux, rstats = c["ref"][codec]
    hops = stats["hop_coded_bits"]
    assert hops.shape == (TP, 2 * (TP - 1))
    np.testing.assert_array_equal(hops.numpy(),
                                  np.asarray(rstats["hop_coded_bits"],
                                             np.float64))
    for k in ("raw_wire_bits", "coded_wire_bits", "payload_coded_bits",
              "hops"):
        np.testing.assert_array_equal(
            stats[k].numpy(), np.asarray(rstats[k], np.float64), err_msg=k)
    assert 0 < float(stats["coded_wire_bits"][0]) < float(
        stats["raw_wire_bits"][0])
    np.testing.assert_allclose(y.float().numpy(), np.float32(ry), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(aux.numpy(), raux, rtol=1e-5)
    # the aux loss is the mean of the ranks' losses, not the global one
    assert float(aux[0]) == pytest.approx(float(aux_sc), rel=0.1)


def test_a2a_block_on_two_axis_loopback_mesh():
    """``moe_apply_a2a_block`` under ``data`` × ``model`` meshes (either
    dim order): the global batch split over 4 ranks and joined back,
    bit-identical to ``moe_apply``; the returned coded bits are the sum
    of every rank's hop ledger."""
    _, tcfg = _cfgs(**MOE, dtype="bfloat16", n_shared_experts=1)
    _, tp = _moe_params(tcfg, 3)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(8, 12, 64)).astype(np.float32)).to(torch.bfloat16)
    y_sc, aux_sc = moe.moe_apply(tp, x, tcfg)
    books = moe._a2a_wire_books("bf16")
    for sizes in ({"data": 2, "model": 2}, {"model": 2, "data": 2}):
        mesh = loopback_mesh(sizes)
        with moe.use_mesh(mesh):
            y, aux, coded = moe.moe_apply_a2a_block(tp, x, tcfg)
        assert torch.equal(_bits(y), _bits(y_sc))
        assert aux.shape == () and float(aux) == pytest.approx(
            float(aux_sc), rel=0.1)
        xs, _ = moe._split_batch(x, mesh, ("data", "model"))
        _, _, st = moe.moe_apply_a2a(tp, xs, tcfg, mesh["model"], books,
                                     chunk=512, decode_backend="auto")
        assert float(coded) == float(st["hop_coded_bits"].sum()) > 0


def test_a2a_refusals_and_fallbacks():
    _, bad = _cfgs(**dict(MOE, n_experts=3), dtype="bfloat16")
    _, tp3 = _moe_params(bad, 0)
    x = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not divisible"):
        moe.moe_apply_a2a(tp3, x, bad, LoopbackAxis(2),
                          moe._a2a_wire_books("bf16"))
    _, tcfg = _cfgs(**MOE, dtype="bfloat16")
    _, tp = _moe_params(tcfg, 0)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(6, 8, 64)).astype(np.float32)).to(torch.bfloat16)
    y_sc, aux_sc = moe.moe_apply(tp, x, tcfg)
    # no mesh, no model axis, model of 1, experts or batch indivisible
    for mesh in (None, {"data": 2}, {"model": 1}, {"model": 3},
                 {"model": 4}):
        ctx = moe.use_mesh(None if mesh is None else loopback_mesh(mesh))
        with ctx:
            y, aux, coded = moe.moe_apply_a2a_block(tp, x, tcfg)
        assert torch.equal(_bits(y), _bits(y_sc)), mesh
        assert float(aux) == float(aux_sc) and float(coded) == 0.0
    assert moe.current_mesh() is None
    # eshard runs: without a mesh it is moe_apply, on a data x model mesh
    # its own path (tests/test_torch_eshard.py holds it to the reference)
    y, aux = moe.moe_apply_eshard(tp, x, tcfg)
    assert torch.equal(_bits(y), _bits(y_sc)) and float(aux) == float(aux_sc)
    y, aux = moe.moe_apply_eshard(tp, x, tcfg,
                                  loopback_mesh({"data": 2, "model": 2}))
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())
    assert aux.shape == () and float(aux) > 0


def _no_router(tree):
    if isinstance(tree, dict):
        return {k: _no_router(v) for k, v in tree.items() if k != "router"}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_no_router(v) for v in tree)
    return tree


def test_a2a_train_step_equals_scatter_step():
    """Reduced llama4 under a loopback ``model`` mesh of 4: with
    ``router_aux_weight = 0`` the a2a path's loss and gradients are the
    scatter path's bit for bit (the wire's backward is an exact
    permutation); with the default weight only the aux loss differs (a
    mean of per-rank losses): the loss and every leaf but the router are
    within ``STEP_TOL`` after a whole step.  At top-1 the router's
    gradient is the aux loss's alone (a renormalised top-1 weight is 1),
    so it follows the other function by design."""
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    mesh = loopback_mesh({"model": TP})

    quiet = replace(cfg, router_aux_weight=0.0)
    l0, (ce0, _, w0), g0 = tstep.loss_and_grads(params, batch, quiet)
    with moe.use_mesh(mesh):
        l1, (ce1, _, w1), g1 = tstep.loss_and_grads(
            params, batch, replace(quiet, moe_impl="a2a"))
    assert torch.equal(l0, l1) and torch.equal(ce0, ce1)
    assert float(w0) == 0.0 < float(w1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(_bits(a), _bits(b))

    opt = adamw.AdamWConfig(lr=1e-3)
    out = {}
    for impl in ("scatter", "a2a"):
        c = replace(cfg, moe_impl=impl)
        with moe.use_mesh(mesh):
            loss, (ce, _, _), grads = tstep.loss_and_grads(params, batch, c)
            state, m = tstep.make_train_step(c, opt)(
                tstep.train_state_init(tree_map(torch.clone, params)), batch)
        out[impl] = ({"loss": loss, "ce": ce, "grads": _no_router(grads),
                      "params": _no_router(state.params)}, m)
    dev = tstep.step_deviation(out["a2a"][0], out["scatter"][0], lr=1e-3)
    assert all(v <= tstep.STEP_TOL[k] for k, v in dev.items()), dev
    assert float(out["a2a"][1]["moe_wire_coded_bits"]) > 0
    assert float(out["scatter"][1]["moe_wire_coded_bits"]) == 0.0


# ------------------------------------------------ wire config, configs
@pytest.fixture
def a2a_wire_state():
    """Both packages' process-global wire config, restored afterwards."""
    saved = (dict(ref_moe._A2A_WIRE), dict(moe._A2A_WIRE))
    yield
    ref_moe._A2A_WIRE.clear()
    ref_moe._A2A_WIRE.update(saved[0])
    moe._A2A_WIRE.clear()
    moe._A2A_WIRE.update(saved[1])


def test_a2a_wire_fingerprint_equals_reference(a2a_wire_state):
    assert moe.a2a_wire_fingerprint() == ref_moe.a2a_wire_fingerprint() \
        == "a2a:unconfigured"
    rng = np.random.default_rng(9)
    counts = {p: rng.integers(0, 50, 256) for p in ("lo", "hi")}
    for codec, chunk in (("huffman", 256), ("qlc", None)):
        ref_moe.configure_a2a_wire({p: ref_build(n, codec=codec)
                                    for p, n in counts.items()}, chunk=chunk)
        moe.configure_a2a_wire({p: build_codebook(n, codec=codec)
                                for p, n in counts.items()}, chunk=chunk)
        fp = moe.a2a_wire_fingerprint()
        assert fp.startswith("a2a:") and fp == ref_moe.a2a_wire_fingerprint()
    books = {p: build_codebook(n) for p, n in counts.items()}
    rbooks = {p: ref_build(n) for p, n in counts.items()}
    ref_moe.configure_a2a_wire(spec=RefSpec.from_books(
        rbooks, "bf16", mode="bitexact", chunk=1024))
    moe.configure_a2a_wire(spec=CompressionSpec.from_books(
        books, "bf16", mode="bitexact", chunk=1024))
    assert moe.a2a_wire_fingerprint() == ref_moe.a2a_wire_fingerprint()
    assert moe._A2A_WIRE["chunk"] == 1024
    with pytest.raises(ValueError, match="either books or spec"):
        moe.configure_a2a_wire(books, spec=CompressionSpec.from_books(
            books, "bf16", mode="bitexact"))


def test_bootstrap_books_equal_reference():
    """The bootstrap sample's 65 536 bf16 bit patterns (the reference
    rounds a float64 draw through ml_dtypes), and so its books."""
    want = np.random.default_rng(0).normal(0.0, 1.0, 1 << 16).astype(
        ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(
        moe.bootstrap_sample().view(torch.int16).numpy(), want)
    assert ref_moe._A2A_WIRE["books"] is moe._A2A_WIRE["books"] is None
    got = moe._a2a_wire_books("bf16")
    ref = ref_moe._a2a_wire_books("bf16")
    assert set(got) == set(ref) == {"lo", "hi"}
    for p in got:
        np.testing.assert_array_equal(np.asarray(got[p].lengths),
                                      np.asarray(ref[p].lengths))
        np.testing.assert_array_equal(np.asarray(got[p].codes),
                                      np.asarray(ref[p].codes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_fields_equal_reference(arch):
    """Every field the port's config has, full and ``reduced()``, equals
    the reference's (dtypes by name); the grad-accum split too."""
    for got, want in ((get_config(arch), ref_get_config(arch)),
                      (get_config(arch).reduced(),
                       ref_get_config(arch).reduced())):
        for f in fields(got):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name == "blocks":
                g = [(b.pattern, b.repeats) for b in g]
                w = [(b.pattern, b.repeats) for b in w]
            elif f.name in ("dtype", "kv_cache_dtype"):
                g = None if g is None else str(g).split(".")[-1]
                w = None if w is None else jnp.dtype(w).name
            assert g == w, (arch, f.name)
    assert train_grad_accum(arch) == ref_grad_accum(arch)


_GLOO = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.comm import ProcessGroupAxis
from repro_torch.models import moe
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
case = torch.load(out + ".case.pt", weights_only=False)
x = case["x"][rank].clone().requires_grad_(True)
y, aux, st = moe.moe_apply_a2a(case["params"], x, case["cfg"],
                               ProcessGroupAxis(), case["books"], chunk=64)
(y.float() ** 2).sum().backward()
torch.save({"y": y.detach(), "aux": aux.detach(), "grad": x.grad,
            "stats": st},
           f"{out}.{rank}.pt")
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """Starts ``moe_apply_a2a`` on a gloo world of two processes, one
    rank each, and yields the case with the running processes."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    _, tcfg = _cfgs(**MOE, dtype="bfloat16", n_shared_experts=1)
    _, tp = _moe_params(tcfg, 8)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, 2, 12, 64)).astype(np.float32)).to(torch.bfloat16)
    books = moe._a2a_wire_books("bf16")
    run = tmp_path_factory.mktemp("gloo") / "run"
    torch.save({"x": x, "params": tp, "cfg": tcfg, "books": books},
               f"{run}.case.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r), str(port),
                               str(run)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        yield {"procs": procs, "run": run, "x": x, "params": tp,
               "cfg": tcfg, "books": books}
    finally:
        for p in procs:
            p.kill()
            p.wait()


def test_a2a_on_a_process_group_equals_loopback(gloo_world):
    """``moe_apply_a2a`` on a ``ProcessGroupAxis`` (a gloo world of two
    processes, one rank each) against ``LoopbackAxis(2)``: every hop's
    coded bits, and the forward and the wire's straight-through backward
    at float32 tolerance (the router and shared expert see one rank's
    rows there, all ranks' rows on the loopback)."""
    w = gloo_world
    logs = [p.communicate(timeout=120)[0] for p in w["procs"]]
    assert all(p.returncode == 0 for p in w["procs"]), logs
    tp, tcfg, books = w["params"], w["cfg"], w["books"]

    xl = w["x"].clone().requires_grad_(True)
    y, aux, st = moe.moe_apply_a2a(tp, xl, tcfg, LoopbackAxis(2), books,
                                   chunk=64)
    (y.float() ** 2).sum().backward()
    aux = aux.detach()
    for r in range(2):
        got = torch.load(f"{w['run']}.{r}.pt", weights_only=False)
        for k, v in st.items():
            np.testing.assert_array_equal(got["stats"][k].numpy(),
                                          v[r].numpy(), err_msg=k)
        np.testing.assert_allclose(got["y"].float().numpy(),
                                   y[r].detach().float().numpy(),
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(got["grad"].float().numpy(),
                                   xl.grad[r].float().numpy(),
                                   rtol=2e-2, atol=2e-2)
        assert float(got["aux"]) == pytest.approx(float(aux[r]), rel=1e-5)
