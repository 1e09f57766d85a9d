"""Port parity, Mamba-2 slice: ``repro_torch.models.ssm``, the ``mamba``
block kind and the ``mamba2-780m`` config against the JAX reference on
the CPU.

Weights are drawn by the port's ``mamba_init`` / ``model_init``
(seeded), held as one numpy tree, given to the reference as arrays and
to the port through ``models.convert``.  The reference's functions are
jitted once a module.  float32 is held at rtol = atol = 1e-5 (readings
up to 6.8e-7 of the output's max: the port's SSD contracts in
two-operand products in a fixed order, the reference's einsums in the
order XLA plans); bf16 at ``BF16`` (max |Δ| over the output's max |·|,
readings 0–6.2e-3: one or two bf16 ulps; about 3× the largest
reading).  The
chunked SSD is also held to the naive O(L) recurrence in float64 at the
reference's own tolerance (rtol = atol = 2e-4, ``tests/test_models.py``).
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import BlockGroup as RefGroup  # noqa: E402
from repro.models import blocks as ref_blocks  # noqa: E402
from repro.models import decode_step as ref_decode  # noqa: E402
from repro.models import prefill as ref_prefill  # noqa: E402
from repro.models import forward_train as ref_forward  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.common import Axes  # noqa: E402
from repro.models.common import ModelConfig as RefConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import step as ref_step  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (BlockGroup, ModelConfig,  # noqa: E402
                                decode_step, forward, forward_train,
                                init_caches, model_init, prefill)
from repro_torch.models import blocks, ssm  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = 2e-2
NAIVE = dict(rtol=2e-4, atol=2e-4)
# d 64, expand 2: 4 heads of 32, state 16, chunks of 8
MAMBA = dict(d_model=64, vocab_size=32, ssm_state=16, ssm_head_dim=32,
             ssm_chunk=8)
ARCH = "mamba2-780m"


def _np(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def _cfgs(dtype="float32", **kw):
    """(reference cfg, port cfg), dtype by name."""
    rcfg = RefConfig(name="m", arch_type="x", blocks=(),
                     dtype=getattr(jnp, dtype), **kw)
    tcfg = ModelConfig(name="m", arch_type="x", blocks=(),
                       dtype=getattr(torch, dtype), **kw)
    return rcfg, tcfg


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **F32)
    else:       # a bf16 model's outputs, and its float32 state
        assert _rel(got.float().numpy(), want) < BF16


def _tails_equal(tc, rc, dtype):
    """The conv tails (raw projections): bf16 bit for bit; float32 at
    ``F32`` (the projections' sums add in other orders)."""
    for k in ("conv_x", "conv_B", "conv_C"):
        if dtype == "float32":
            _check(tc[k], rc[k], dtype)
        else:
            np.testing.assert_array_equal(_np(tc[k]), np.asarray(rc[k]))


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _params(tcfg, seed=0):
    """Seeded mamba params (dt_bias, D and the norm scale drawn too, so
    they are not at their zero/one inits) as numpy and as port
    tensors."""
    gen = torch.Generator().manual_seed(seed)
    p = ssm.mamba_init(tcfg, gen, "cpu")
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen) * 0.5
    p["D"] = 1.0 + torch.randn(p["D"].shape, generator=gen) * 0.2
    p["norm"]["scale"] = torch.randn(p["norm"]["scale"].shape,
                                     generator=gen) * 0.2
    np_p = tree_map(_np, p)
    return np_p, tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_p)


# --------------------------------------------------- the Mamba functions
_ref_conv = jax.jit(ref_ssm._causal_conv)
_ref_apply = jax.jit(ref_ssm.mamba_apply, static_argnums=2)
_ref_prefill = jax.jit(ref_ssm.mamba_prefill, static_argnums=(2, 3))
_ref_decode = jax.jit(ref_ssm.mamba_decode, static_argnums=4)
_ref_ssd = jax.jit(ref_ssm.ssd_chunked, static_argnums=(5, 6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_functions_equal_reference(dtype):
    """``_causal_conv``, ``mamba_apply`` at 13 steps (a length that is
    not a multiple of the chunk of 8: padded inside), ``mamba_prefill``
    (output, final state and conv tails; 2 prompt steps, fewer than the
    tail, and 6, inside one padded chunk) and five ``mamba_decode`` steps
    continuing the prefill's cache in place."""
    rcfg, tcfg = _cfgs(dtype, **MAMBA)
    np_p, tp = _params(tcfg)
    rp = jax.tree.map(jnp.asarray, np_p)
    x = _x((2, 13, 64), dtype, 1)
    xt = tensor_from_numpy(x, "cpu")
    xh = _x((2, 13, 4, 32), dtype, 2)
    _check(ssm._causal_conv(tensor_from_numpy(xh, "cpu"), tp["conv_x"]),
           _ref_conv(xh, rp["conv_x"]), dtype)
    _check(ssm.mamba_apply(tp, xt, tcfg), _ref_apply(rp, x, rcfg), dtype)
    for head in (2, 6):
        ry, rc = _ref_prefill(rp, x[:, :head], rcfg, 0)
        ty, tc = ssm.mamba_prefill(tp, xt[:, :head], tcfg)
        _check(ty, ry, dtype)
        assert tc["state"].dtype == torch.float32
        _check(tc["state"], rc["state"], dtype)
        _tails_equal(tc, rc, dtype)
    for t in range(6, 11):
        ry, rc = _ref_decode(rp, x[:, t:t + 1], rc, jnp.int32(t), rcfg)
        ty, tc2 = ssm.mamba_decode(tp, xt[:, t:t + 1], tc, t, tcfg)
        assert tc2 is tc                       # updated in place
        _check(ty, ry, dtype)
        _check(tc["state"], rc["state"], dtype)
        _tails_equal(tc, rc, dtype)


def _ssd_case(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.5, size=(b, l, h)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32),
            rng.normal(size=(b, l, h, n)).astype(np.float32),
            rng.normal(size=(b, l, h, n)).astype(np.float32))


def _naive(x, dt, a_neg, bb, cc):
    """The O(L) recurrence in float64 (``tests/test_models.py``'s
    oracle): (y, final state)."""
    b, l, h, p = x.shape
    state = np.zeros((b, h, p, bb.shape[-1]))
    ys = np.zeros((b, l, h, p))
    for t in range(l):
        da = np.exp(dt[:, t].astype(np.float64) * a_neg[None, :])
        state = (state * da[..., None, None]
                 + dt[:, t][..., None, None]
                 * x[:, t][..., :, None] * bb[:, t][:, :, None, :])
        ys[:, t] = (state * cc[:, t][:, :, None, :]).sum(-1)
    return ys, state


@pytest.mark.parametrize("final", [False, True])
def test_ssd_chunked_equals_naive_recurrence_and_reference(final):
    """``ssd_chunked`` at 4 chunks of 32 against the float64 recurrence
    (the reference's tolerance) and against the reference's own
    ``ssd_chunked`` (float32), with and without the final state."""
    case = _ssd_case(0, 2, 128, 3, 8, 4)
    got = ssm.ssd_chunked(*map(torch.from_numpy, case), chunk=32,
                          return_final_state=final)
    want = _ref_ssd(*case, 32, final)
    ys, state = _naive(*case)
    if final:
        (got, got_s), (want, want_s) = got, want
        np.testing.assert_allclose(got_s.numpy(), state, **NAIVE)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **F32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ys, **NAIVE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_segsum_equals_reference_and_backward_is_finite():
    """``_segsum`` against the reference's (float32, −inf above the
    diagonal at the same places); its −inf mask is a ``where`` before
    the ``exp``, so the gradient through the masked entries is 0, not
    NaN."""
    a = np.random.default_rng(3).normal(size=(2, 6)).astype(np.float32)
    np.testing.assert_allclose(ssm._segsum(torch.from_numpy(a)).numpy(),
                               np.asarray(jax.jit(ref_ssm._segsum)(a)),
                               **F32)
    t = torch.from_numpy(a).double().requires_grad_(True)
    torch.exp(ssm._segsum(t)).sum().backward()
    assert bool(torch.isfinite(t.grad).all())
    assert torch.isinf(ssm._segsum(t.detach())).sum() == 2 * 15


# ----------------------------------------------------------- the block
def test_mamba_block_param_keys_equal_reference():
    """A ``mamba`` block has no FFN: its tree holds the reference's keys
    and leaf shapes (no ``norm_ffn`` or ``ffn``); the port knows the
    reference's ten block kinds."""
    assert blocks.BLOCK_KINDS == ref_blocks.BLOCK_KINDS
    rcfg, tcfg = _cfgs("bfloat16", **MAMBA)
    want = jax.eval_shape(lambda k: ref_blocks.block_init(
        "mamba", k, rcfg, Axes()), jax.random.PRNGKey(0))
    got = blocks.block_init("mamba", tcfg, torch.Generator(), "cpu")
    assert set(got) == set(want) == {"norm_mix", "mixer"}
    assert jax.tree.structure(tree_map(lambda _: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, want))
    for g, w in zip(jax.tree.leaves(tree_map(lambda t: t.shape, got),
                                    is_leaf=lambda x: isinstance(x, tuple)),
                    jax.tree.leaves(jax.tree.map(lambda a: a.shape, want),
                                    is_leaf=lambda x: isinstance(x, tuple))):
        assert tuple(g) == tuple(w)


def test_decode_matches_forward_and_prefill_handoff():
    """The reference's ``tests/test_models.py`` checks (float32) on a
    ``repeats = 2`` stack of ``mamba``, so a decode that lost its
    in-place state write after the first layer shows: decode from empty
    caches and a prefill hand-off both follow the full forward at
    rel < 1e-4 (the full forward pads 12 steps to a chunk of 128)."""
    cfg = ModelConfig(name="t", arch_type="x", d_model=128, vocab_size=256,
                      blocks=(BlockGroup(("mamba",), 2),), ssm_state=16,
                      ssm_head_dim=32, remat="none", dtype=torch.float32)
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 12)))
    logits = forward(params, {"tokens": tok}, cfg)

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-9))

    caches = init_caches(cfg, 2, 32, device="cpu")
    assert set(caches[0][0]) == {"state", "conv_x", "conv_B", "conv_C"}
    outs = [decode_step(params, tok[:, t:t + 1], caches, t, cfg)[0]
            for t in range(12)]
    assert rel(torch.cat(outs, 1), logits) < 1e-4
    lg, caches = prefill(params, {"tokens": tok[:, :7]}, cfg, 32)
    assert rel(lg, logits[:, :7]) < 1e-4
    for t in range(7, 12):
        lg, caches = decode_step(params, tok[:, t:t + 1], caches, t, cfg)
        assert rel(lg[:, 0], logits[:, t]) < 1e-4


def test_bf16_decode_drift_equals_reference():
    """In bf16 a deep random mamba stack carries a rounding of its input
    far through its layers, so a decode replay parts from the full
    prefill well beyond a bf16 ulp, in the reference as in the port: on
    the same weights (8 layers, d 128, state 128, heads of 64) the port's
    replay drifts as far as the reference's (within 2× either way; the
    readings grow about linearly with depth, ~0.3 of the logits' max at
    48 layers), which is why ``chip_smoke.py`` holds mamba2-780m's
    full-depth replay on float32 weights."""
    kw = dict(name="t", arch_type="x", d_model=128, vocab_size=256,
              ssm_state=128, ssm_head_dim=64, remat="none")
    tcfg = ModelConfig(blocks=(BlockGroup(("mamba",), 8),),
                       dtype=torch.bfloat16, **kw)
    rcfg = RefConfig(blocks=(RefGroup(("mamba",), 8),), dtype=jnp.bfloat16,
                     **kw)
    params = model_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    rp = jax.tree.map(lambda t: jnp.asarray(_np(t)), params)
    seq = np.random.default_rng(1).integers(0, 256, (2, 24))
    head = 12

    def f32(a):
        return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                          np.float32)

    def drift(pre, dec, p, cfg, tok, pos):
        _, caches = pre(p, {"tokens": tok(seq[:, :head])}, cfg, 32)
        outs = []
        for t in range(head, 24):
            lg, caches = dec(p, tok(seq[:, t:t + 1]), caches, pos(t), cfg)
            outs.append(f32(lg[:, 0]))
        full, _ = pre(p, {"tokens": tok(seq)}, cfg, 32)
        return _rel(np.stack(outs, 1), f32(full[:, head:]))

    with torch.no_grad():
        got = drift(prefill, decode_step, params, tcfg, torch.from_numpy,
                    int)
    want = drift(jax.jit(ref_prefill, static_argnums=(2, 3)),
                 jax.jit(ref_decode, static_argnums=4), rp, rcfg,
                 jnp.asarray, jnp.int32)
    print(f"bf16 decode drift, 8 layers: port {got:.3e}, reference "
          f"{want:.3e}")
    assert want > 1e-2                  # the reference drifts too
    assert want / 2 <= got <= 2 * want


# ---------------------------------------------------------- mamba2-780m
@pytest.fixture(scope="module")
def mamba2():
    """The reduced config (one mamba layer at d 256, state 32, tied
    embeddings, bf16): the port's seeded params as numpy, a batch, and
    the reference's jitted forward and train step from them."""
    tcfg = get_config(ARCH).reduced()
    rcfg = ref_get_config(ARCH).reduced()
    np_params = tree_map(_np, model_init(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    tok = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 16))
    batch = {"tokens": tok.astype(np.int32),
             "labels": np.roll(tok, -1, 1).astype(np.int32)}
    rp = jax.tree.map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(ref_step.make_train_step(
        rcfg, ref_adamw.AdamWConfig(lr=1e-3)))
    new_state, metrics = step(ref_step.train_state_init(rp), jb)
    logits, _ = jax.jit(ref_forward, static_argnums=2)(
        rp, {"tokens": jb["tokens"]}, rcfg)
    return {"tcfg": tcfg, "np_params": np_params, "batch": batch,
            "logits": np.asarray(logits, np.float32),
            "new_state": jax.device_get(
                new_state), "metrics": jax.device_get(metrics)}


def test_reduced_mamba2_forward_equals_reference(mamba2):
    """bf16 logits within ``BF16`` of the reference's, params carried
    across by ``from_jax_params`` (which checks the ``mamba`` heads)."""
    c = mamba2
    tparams = from_jax_params(c["np_params"], c["tcfg"], device="cpu")
    got, _ = forward_train(
        tparams, {"tokens": torch.from_numpy(c["batch"]["tokens"])},
        c["tcfg"])
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), c["logits"]) < BF16
    with pytest.raises(ValueError, match="wx"):
        from_jax_params(c["np_params"], replace(c["tcfg"], ssm_head_dim=64),
                        device="cpu")


def test_reduced_mamba2_train_step_within_step_tol(mamba2):
    """One AdamW step of the reduced config in bf16, port vs reference:
    loss, grad norm, first moments and params within ``STEP_TOL``
    (readings loss 9.3e-8, grad norm 1.5e-4, grads 1.08e-2, param_steps
    1.998, param_flips 3.9e-3)."""
    c = mamba2
    tparams = from_jax_params(c["np_params"], c["tcfg"], device="cpu")
    step = tstep.make_train_step(c["tcfg"], adamw.AdamWConfig(lr=1e-3))
    new, m = step(tstep.train_state_init(tparams),
                  {k: torch.from_numpy(v.astype(np.int64))
                   for k, v in c["batch"].items()})
    rm, rs = c["metrics"], c["new_state"]
    dev = tstep.step_deviation(
        {"loss": m["loss"], "ce": m["ce"], "grad_norm": m["grad_norm"],
         "m": new.opt.m, "params": new.params},
        {"loss": rm["loss"], "ce": rm["ce"], "grad_norm": rm["grad_norm"],
         "m": rs.opt.m, "params": rs.params}, 1e-3)
    print("step_deviation", dev)
    assert set(dev) == {"loss", "grad_norm", "grads", "param_steps",
                        "param_flips"}
    assert all(v <= tstep.STEP_TOL[k] for k, v in dev.items()), dev
