"""Port parity, RG-LRU slice: ``repro_torch.models.rglru``, the ``rec``
block kind, the ``recurrentgemma-9b`` config and its coded-KV serve
against the JAX reference on the CPU.

Weights are drawn by the port's ``rglru_init`` / ``model_init``
(seeded), held as one numpy tree, given to the reference as arrays and
to the port through ``models.convert``.  The reference's functions are
jitted once a module.  float32 is held at rtol = atol = 1e-5 (readings
up to 4.7e-6 of the output's max: the scan combines in the reference's
order, the products add in other orders); bf16 at ``BF16`` (max |Δ|
over the output's max |·|, readings 0–6.7e-3: one or two bf16 ulps
from the products' sums; about 3× the largest reading).  The scan is
held to a float64 loop at rtol = atol = 1e-5 as well.
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.memstore import CodedKVStore as RefKV  # noqa: E402
from repro.models import forward_train as ref_forward  # noqa: E402
from repro.models import rglru as ref_rglru  # noqa: E402
from repro.models.common import ModelConfig as RefConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import step as ref_step  # noqa: E402

from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.memstore import CodedKVStore  # noqa: E402
from repro_torch.models import (BlockGroup, ModelConfig,  # noqa: E402
                                decode_step, forward, forward_train,
                                init_caches, model_init, prefill)
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = 2e-2
REC = dict(d_model=64, vocab_size=32, lru_width=64)
ARCH = "recurrentgemma-9b"


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
    else:       # a bf16 model's outputs, and its float32 gates and h
        assert _rel(got.float().numpy(), want) < BF16


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


# --------------------------------------------------- the RG-LRU functions
_ref_gates = jax.jit(ref_rglru._gates)
_ref_conv = jax.jit(ref_rglru._causal_conv1d)
_ref_apply = jax.jit(ref_rglru.rglru_apply, static_argnums=2)
_ref_prefill = jax.jit(ref_rglru.rglru_prefill, static_argnums=(2, 3))
_ref_decode = jax.jit(ref_rglru.rglru_decode, static_argnums=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_functions_equal_reference(dtype):
    """``_gates``, ``_causal_conv1d``, ``rglru_apply``, ``rglru_prefill``
    (its cache too: 2 prompt tokens, fewer than the conv's tail, so the
    tail is zero-padded, then 8) and five ``rglru_decode`` steps
    continuing the prefill's cache in place."""
    rcfg, tcfg = _cfgs(dtype, **REC)
    gen = torch.Generator().manual_seed(0)
    np_p = tree_map(_np, rglru.rglru_init(tcfg, gen, "cpu"))
    rp = jax.tree.map(jnp.asarray, np_p)
    tp = tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_p)
    x = _x((2, 13, 64), dtype, 1)
    xt = tensor_from_numpy(x, "cpu")

    for got, want in zip(rglru._gates(tp, xt), _ref_gates(rp, x)):
        _check(got, want, dtype)
    _check(rglru._causal_conv1d(xt, tp["conv"]), _ref_conv(x, rp["conv"]),
           dtype)
    _check(rglru.rglru_apply(tp, xt, tcfg), _ref_apply(rp, x, rcfg), dtype)
    for head in (2, 8):
        ry, rc = _ref_prefill(rp, x[:, :head], rcfg, 0)
        ty, tc = rglru.rglru_prefill(tp, xt[:, :head], tcfg)
        _check(ty, ry, dtype)
        assert tc["h"].dtype == torch.float32
        _check(tc["h"], rc["h"], dtype)
        np.testing.assert_array_equal(_np(tc["conv"]), np.asarray(rc["conv"]))
    for t in range(8, 13):
        ry, rc = _ref_decode(rp, x[:, t:t + 1], rc, jnp.int32(t), rcfg)
        ty, tc2 = rglru.rglru_decode(tp, xt[:, t:t + 1], tc, t, tcfg)
        assert tc2 is tc                       # updated in place
        _check(ty, ry, dtype)
        _check(tc["h"], rc["h"], dtype)
        np.testing.assert_array_equal(_np(tc["conv"]), np.asarray(rc["conv"]))


@pytest.mark.parametrize("length", [1, 2, 3, 7, 64, 257])
def test_linear_scan_equals_float64_loop(length):
    """The odd/even scan against h_t = a_t h_{t−1} + b_t in float64, at
    lengths that reach the recursion's odd tails; a near 1 as the
    block's gates give it (0.9–0.999)."""
    rng = np.random.default_rng(length)
    a = rng.uniform(0.9, 0.999, (2, length, 5)).astype(np.float32)
    b = rng.normal(size=(2, length, 5)).astype(np.float32)
    acc, h = rglru._linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    want_h = np.zeros((2, length, 5))
    want_a = np.zeros((2, length, 5))
    hh, aa = np.zeros((2, 5)), np.ones((2, 5))
    for t in range(length):
        hh = a[:, t].astype(np.float64) * hh + b[:, t]
        aa = aa * a[:, t]
        want_h[:, t], want_a[:, t] = hh, aa
    np.testing.assert_allclose(h.numpy(), want_h, **F32)
    np.testing.assert_allclose(acc.numpy(), want_a, **F32)


# ----------------------------------- blocks: decode = forward, handoff
KINDS = [("rec",), ("rec", "rec", "local")]


@pytest.mark.parametrize("kinds", KINDS, ids=str)
def test_decode_matches_forward_and_prefill_handoff(kinds):
    """The reference's ``tests/test_models.py`` checks (float32) on
    ``repeats = 2`` stacks, so a decode that lost its in-place state
    write after the first layer shows: decode from empty caches and a
    prefill hand-off both follow the full forward at rel < 1e-4."""
    cfg = ModelConfig(name="t", arch_type="x", d_model=128, vocab_size=256,
                      blocks=(BlockGroup(kinds, 2),), n_heads=4,
                      n_kv_heads=2, head_dim=32, d_ff=256, lru_width=128,
                      sliding_window=8, remat="none", dtype=torch.float32)
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 12)))
    logits = forward(params, {"tokens": tok}, cfg)

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-9))

    caches = init_caches(cfg, 2, 32, device="cpu")
    assert "pos" not in caches[0][0]
    outs = [decode_step(params, tok[:, t:t + 1], caches, t, cfg)[0]
            for t in range(12)]
    assert rel(torch.cat(outs, 1), logits) < 1e-4
    lg, caches = prefill(params, {"tokens": tok[:, :7]}, cfg, 32)
    assert rel(lg, logits[:, :7]) < 1e-4
    for t in range(7, 12):
        lg, caches = decode_step(params, tok[:, t:t + 1], caches, t, cfg)
        assert rel(lg[:, 0], logits[:, t]) < 1e-4


# --------------------------------------------------- recurrentgemma-9b
@pytest.fixture(scope="module")
def gemma():
    """The reduced config (rec, rec, local at d 256) in float32: the
    port's seeded params as numpy, a batch, and the reference's jitted
    forward and train step from them.

    float32, not the config's bf16: in bf16 the two packages' steps part
    by bf16 rounding alone, at the limits (readings loss 2.7e-4, grad
    norm 9.5e-5, grads 2.03e-2 of a leaf's max, param_steps 2.0009: a
    near-zero gradient whose sign differs moves a weight by 2·lr, and its
    larger side rounds by more than the smaller side's ulp), so a bf16
    comparison measures rounding noise, not the step.  The reduced
    mamba2-780m's bf16 step is within the limits and is held in bf16
    (``test_torch_ssm.py``)."""
    tcfg = get_config(ARCH).reduced(dtype=torch.float32)
    rcfg = ref_get_config(ARCH).reduced(dtype=jnp.float32)
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
            "logits": np.asarray(logits), "new_state": jax.device_get(
                new_state), "metrics": jax.device_get(metrics)}


def test_reduced_recurrentgemma_forward_equals_reference(gemma):
    """Logits at float32 tolerance (1e-4, as the reduced DeepSeek's),
    params carried across by ``from_jax_params`` (which checks the
    ``rec`` width)."""
    c = gemma
    tparams = from_jax_params(c["np_params"], c["tcfg"], device="cpu")
    got, _ = forward_train(
        tparams, {"tokens": torch.from_numpy(c["batch"]["tokens"])},
        c["tcfg"])
    np.testing.assert_allclose(got.detach().numpy(), c["logits"], rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="w_in"):
        from_jax_params(c["np_params"], replace(c["tcfg"], lru_width=128),
                        device="cpu")


def test_reduced_recurrentgemma_train_step_within_step_tol(gemma):
    """One AdamW step of the reduced config, port vs reference: loss,
    grad norm, first moments and params within ``STEP_TOL``."""
    c = gemma
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


def test_coded_kv_serve_codes_the_local_layer_and_passes_the_state():
    """``kv_mode="coded"`` on the reduced hybrid (bf16): the local
    layer's K/V are coded, the two ``rec`` layers' ``{h, conv}`` pass
    through raw; the tokens are the raw engine's, and on the same prefill
    caches the port's store and the reference's count the same raw and
    coded bits with the same books."""
    tcfg = get_config(ARCH).reduced()
    params = model_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 8))
    book = build_codebook(np.ones(256), codec="huffman")
    spec = CompressionSpec.from_books({"lo": book, "hi": book}, "bf16",
                                      tensor_kind="act")
    sc = ServeConfig(max_cache_len=16)
    raw, _ = Engine(params, tcfg, sc, device="cpu").generate(prompts, 4)
    eng = Engine(params, tcfg, sc, spec, kv_mode="coded", device="cpu")
    toks, totals = eng.generate(prompts, 4)
    np.testing.assert_array_equal(toks, raw)
    segs = eng._kv._segments
    assert list(segs) == ["[0][2]"]                       # the local layer
    # the raw state counts the same on both sides of the ledger
    assert totals["kv_hbm_raw_bits"] - totals["kv_hbm_coded_bits"] == sum(
        s.raw_bits - s.coded_bits for s in segs["[0][2]"])
    assert eng._kv._raw_leaf_bits() > 0

    _, caches = prefill(params, {"tokens": torch.from_numpy(prompts)}, tcfg,
                        16)
    kv = CodedKVStore(codec="huffman", chunk=96, device="cpu")
    rkv = RefKV(codec="huffman", chunk=96)
    assert kv.ingest(caches) == rkv.ingest(
        jax.tree.map(lambda t: jnp.asarray(_np(t)), caches)) == 8
    assert (kv.kv_hbm_raw_bits, kv.kv_hbm_coded_bits) == (
        rkv.kv_hbm_raw_bits, rkv.kv_hbm_coded_bits)
    assert kv.kv_hbm_coded_bits < kv.kv_hbm_raw_bits
    for p in ("lo", "hi"):
        np.testing.assert_array_equal(kv.books[p].lengths,
                                      rkv.books[p].lengths)
