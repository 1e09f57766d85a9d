"""Port parity, MLA slice: ``repro_torch.models.mla``, the four ``mla*``
block kinds, the ``deepseek-v3-671b`` config and the float8 cache
writes against the JAX reference on the CPU.

Weights are drawn by the port's ``mla_init`` / ``model_init`` (seeded),
held as one numpy tree, given to the reference as arrays and to the
port through ``models.convert``.  The reference's functions run jitted.
float32 is held at rtol = atol = 1e-5; bf16 at ``BF16`` (each
package's einsums add in their own order, and the expanded and absorbed
forms round at different points).  The float8 cache test builds its
inputs so that every cached value is one exact bf16 product in both
packages (one-hot projections, the rotary half that is mixed kept at
zero), so the caches must agree bit for bit, NaNs included.
"""
from dataclasses import fields, replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.memstore import CodedKVStore as RefKV  # noqa: E402
from repro.models import init_caches as ref_init_caches  # noqa: E402
from repro.models import forward_train as ref_forward  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
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
from repro_torch.models import layers, mla  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
# bf16 outputs and caches, port vs reference: max |Δ| over the output's
# max |·| (readings 0–6.7e-3 at these sizes, one or two bf16 ulps: the
# port rounds where the reference's code rounds, and under jit XLA adds
# the two score einsums in float32 before it rounds; about 3× the
# largest reading)
BF16 = 2e-2
MLA = dict(d_model=64, vocab_size=128, n_heads=4, q_lora_rank=32,
           kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16)
FP8 = torch.float8_e4m3fn


def _np(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def _cfgs(dtype="float32", **kw):
    """(reference cfg, port cfg) of one attention layer; dtype by name;
    float8 caches by ``fp8=True``."""
    fp8 = kw.pop("fp8", False)
    rcfg = RefConfig(name="m", arch_type="x", blocks=(),
                     dtype=getattr(jnp, dtype),
                     kv_cache_dtype=jnp.float8_e4m3fn if fp8 else None, **kw)
    tcfg = ModelConfig(name="m", arch_type="x", blocks=(),
                       dtype=getattr(torch, dtype),
                       kv_cache_dtype=FP8 if fp8 else None, **kw)
    return rcfg, tcfg


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mla_params(tcfg, seed):
    """Seeded MLA params (the norm scales drawn too) as a numpy tree and
    as port tensors."""
    gen = torch.Generator().manual_seed(seed)
    p = mla.mla_init(tcfg, gen, "cpu")
    for k in ("q_norm", "kv_norm"):
        p[k]["scale"] = torch.randn(p[k]["scale"].shape, generator=gen) * 0.2
    np_p = tree_map(_np, p)
    return np_p, tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_p)


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    return x


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **F32)
    else:
        assert _rel(got.float().numpy(), want) < BF16


# ------------------------------------------------------ the MLA functions
_ref_apply = jax.jit(ref_mla.mla_apply, static_argnums=2,
                     static_argnames="window")
_ref_prefill = jax.jit(ref_mla.mla_prefill, static_argnums=(2, 3),
                       static_argnames="window")
_ref_decode = jax.jit(ref_mla.mla_decode, static_argnums=4,
                      static_argnames="window")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_mla_functions_equal_reference(dtype, window):
    """``mla_apply``, ``mla_prefill`` (its latent cache too; with a
    window of 5 the ring wraps: 8 tokens into 5 slots) and six
    ``mla_decode`` steps continuing the prefill's cache in place."""
    rcfg, tcfg = _cfgs(dtype, **MLA)
    np_p, tp = _mla_params(tcfg, 0)
    rp = jax.tree.map(jnp.asarray, np_p)
    x = _x((2, 14, 64), dtype, 1)
    xt = tensor_from_numpy(x, "cpu")

    _check(mla.mla_apply(tp, xt, tcfg, window=window),
           _ref_apply(rp, jnp.asarray(x), rcfg, window=window), dtype)
    head, cache_len = 8, 16
    ry, rc = _ref_prefill(rp, jnp.asarray(x[:, :head]), rcfg, cache_len,
                          window=window)
    ty, tc = mla.mla_prefill(tp, xt[:, :head], tcfg, cache_len,
                             window=window)
    _check(ty, ry, dtype)
    assert tc["ckv"].shape[1] == (window or cache_len)
    np.testing.assert_array_equal(tc["pos"].numpy(), rc["pos"])
    for k in ("ckv", "krope"):
        _check(tc[k], rc[k], dtype)
    for t in range(head, 14):
        ry, rc = _ref_decode(rp, jnp.asarray(x[:, t:t + 1]), rc,
                             jnp.int32(t), rcfg, window=window)
        ty, tc2 = mla.mla_decode(tp, xt[:, t:t + 1], tc, t, tcfg,
                                 window=window)
        assert tc2 is tc                       # updated in place
        _check(ty, ry, dtype)
        np.testing.assert_array_equal(tc["pos"].numpy(), rc["pos"])
        for k in ("ckv", "krope"):
            _check(tc[k], rc[k], dtype)


# ----------------------------------------------- float8 cache writes
_ref_attn_prefill = jax.jit(ref_layers.attn_prefill, static_argnums=(2, 3))
_ref_attn_decode = jax.jit(ref_layers.attn_decode, static_argnums=4)
# bf16 values about e4m3fn's largest finite value (448) and the rounding
# edge past which XLA's cast gives NaN (464)
BIG = np.array([300, 440, 448, 456, 460, 462, 464, 466, 470, 480, 500, 1000,
                -300, -448, -464, -466, -500, 0.5, 0, 2], np.float32)


def _onehot(rows, cols, scale=1.0):
    w = np.zeros((rows, cols), np.float32)
    w[np.arange(cols), np.arange(cols)] = scale
    return w


def _fp8_gqa_case():
    """A GQA layer whose v is x itself and whose k is x's first half of
    each head with the rotary partner half zero (k = x₁·cos, x₁·sin: one
    rounding in either package), on inputs past 448 and 464."""
    rcfg, tcfg = _cfgs("bfloat16", fp8=True, d_model=32, vocab_size=8,
                       n_heads=2, n_kv_heads=2, head_dim=16)
    wv = _onehot(32, 32).reshape(32, 2, 16)
    wk = np.zeros((32, 2, 16), np.float32)
    for h in range(2):
        wk[h * 16 + np.arange(8), h, np.arange(8)] = 1.0
    bf = ml_dtypes.bfloat16
    np_p = {"wq": np.zeros((32, 2, 16), bf), "wk": wk.astype(bf),
            "wv": wv.astype(bf), "wo": np.zeros((2, 16, 32), bf)}
    x = np.resize(BIG, (2, 6, 32)) * np.random.default_rng(0).choice(
        [1.0, -1.0], (2, 6, 32))
    return rcfg, tcfg, np_p, x.astype(bf)


def _fp8_mla_case():
    """An MLA layer whose latent is ±(1 + kv_norm scale), one exact
    rmsnorm of a ±1 row scaled past 448 and 464 channel by channel, and
    whose rotary key is 500·x₁ with its partner half zero."""
    rcfg, tcfg = _cfgs("bfloat16", fp8=True, **MLA)
    gen = torch.Generator().manual_seed(3)
    np_p = tree_map(_np, mla.mla_init(tcfg, gen, "cpu"))
    bf = ml_dtypes.bfloat16
    wkv = np.zeros((64, 24), np.float32)
    wkv[np.arange(16), np.arange(16)] = 1.0           # latent ← x[:16]
    wkv[16 + np.arange(4), 16 + np.arange(4)] = 500.0  # rope x₁ ← x[16:20]
    np_p["wkv_a"] = wkv.astype(bf)
    np_p["kv_norm"]["scale"] = (BIG[:16] - 1.0).astype(np.float32)
    x = np.random.default_rng(1).choice([1.0, -1.0], (2, 6, 64))
    return rcfg, tcfg, np_p, x.astype(bf)


def _bits(t):
    return t.view(torch.uint8).numpy()


@pytest.mark.parametrize("mixer", ["gqa", "mla"])
def test_fp8_cache_writes_equal_reference_bits(mixer):
    """Values past 448 and 464 written into a ``float8_e4m3fn`` cache by
    a prefill and by decode steps: the port's cache holds the
    reference's bits (NaN where XLA's cast gives NaN; torch's own cast
    would saturate to ±448), and so its dequantised cache is the
    reference's."""
    if mixer == "gqa":
        rcfg, tcfg, np_p, x = _fp8_gqa_case()
        ref_pre, ref_dec = _ref_attn_prefill, _ref_attn_decode
        pre, dec = layers.attn_prefill, layers.attn_decode
        keys = ("k", "v")
    else:
        rcfg, tcfg, np_p, x = _fp8_mla_case()
        ref_pre, ref_dec = _ref_prefill, _ref_decode
        pre, dec = mla.mla_prefill, mla.mla_decode
        keys = ("ckv", "krope")
    rp = jax.tree.map(jnp.asarray, np_p)
    tp = tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_p)
    xt = tensor_from_numpy(x, "cpu")
    _, rc = ref_pre(rp, jnp.asarray(x[:, :3]), rcfg, 8)
    _, tc = pre(tp, xt[:, :3], tcfg, 8)
    for t in range(3, 6):
        _, rc = ref_dec(rp, jnp.asarray(x[:, t:t + 1]), rc, jnp.int32(t),
                        rcfg)
        _, tc = dec(tp, xt[:, t:t + 1], tc, t, tcfg)
    nan = 0
    for k in keys:
        assert tc[k].dtype == FP8
        want = np.asarray(rc[k]).view(np.uint8)
        np.testing.assert_array_equal(_bits(tc[k]), want, err_msg=k)
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(rc[k], np.float32))
        nan += int(torch.isnan(tc[k].float()).sum())
    assert nan > 0                     # the NaN rule is exercised
    # the cast itself on bf16 values about the edge: XLA's, not torch's
    v = torch.tensor([300, 460, 470, 500, -1000],
                     dtype=torch.bfloat16)
    got = layers.cache_cast(v, FP8).float().tolist()
    assert got[:2] == [288.0, 448.0] and all(np.isnan(got[2:]))


# ------------------------------------------------- blocks: decode = forward
MLA_KINDS = [("mla", {}), ("mla_local", {"sliding_window": 5}),
             ("mla_moe", {"n_experts": 4, "experts_per_token": 2,
                          "moe_d_ff": 64, "n_shared_experts": 1}),
             ("mla_local_moe", {"sliding_window": 5, "n_experts": 4,
                                "experts_per_token": 2, "moe_d_ff": 64})]


@pytest.mark.parametrize("kind,extra", MLA_KINDS,
                         ids=[k for k, _ in MLA_KINDS])
def test_decode_matches_forward_and_prefill_handoff(kind, extra):
    """The reference's ``tests/test_models.py`` checks on the port's MLA
    kinds (float32): decode from empty caches and a prefill hand-off
    both follow the full forward at rel < 1e-4."""
    cfg = ModelConfig(name="t", arch_type="x", blocks=(BlockGroup((kind,), 2),),
                      d_ff=128, remat="none", dtype=torch.float32,
                      **dict(MLA, **extra))
    params = model_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 12)))
    logits = forward(params, {"tokens": tok}, cfg)

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-9))

    caches = init_caches(cfg, 2, 32, device="cpu")
    outs = [decode_step(params, tok[:, t:t + 1], caches, t, cfg)[0]
            for t in range(12)]
    assert rel(torch.cat(outs, 1), logits) < 1e-4
    lg, caches = prefill(params, {"tokens": tok[:, :7]}, cfg, 32)
    assert rel(lg, logits[:, :7]) < 1e-4
    for t in range(7, 12):
        lg, caches = decode_step(params, tok[:, t:t + 1], caches, t, cfg)
        assert rel(lg[:, 0], logits[:, t]) < 1e-4


# ------------------------------------------------------------ DeepSeek
ARCH = "deepseek-v3-671b"


def _fields_equal(got, want):
    for f in fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "blocks":
            g = [(b.pattern, b.repeats) for b in g]
            w = [(b.pattern, b.repeats) for b in w]
        elif f.name in ("dtype", "kv_cache_dtype"):
            g = None if g is None else str(g).split(".")[-1]
            w = None if w is None else jnp.dtype(w).name
        assert g == w, (got.name, f.name)


def test_deepseek_config_and_variants_equal_reference():
    """The config, its ``reduced()``, its ``with_sliding_window`` twin
    (every ``mla*`` kind windowed) and that twin reduced, field for
    field."""
    full, rfull = get_config(ARCH), ref_get_config(ARCH)
    for got, want in ((full, rfull), (full.reduced(), rfull.reduced()),
                      (full.with_sliding_window(4096),
                       rfull.with_sliding_window(4096)),
                      (full.with_sliding_window(4096).reduced(),
                       rfull.with_sliding_window(4096).reduced())):
        _fields_equal(got, want)
    assert full.with_sliding_window(8).layer_kinds[:4] == (
        "mla_local", "mla_local", "mla_local", "mla_local_moe")
    assert full.n_layers == 61 and full.reduced().layer_kinds == (
        "mla", "mla_moe")


@pytest.fixture(scope="module")
def deepseek():
    """The reduced DeepSeek in float32: the port's seeded params as
    numpy, a batch, and the reference's jitted train step from them.

    float32, not the config's bf16: in bf16 the two packages' hidden
    states differ by a bf16 ulp here and there (XLA's jit adds MLA's two
    score einsums in float32 before it rounds; the gated MLP's activation
    rounds at other points), and at top-2 of 4 experts a router margin
    under that rounding sends a token to another expert, so a bf16
    comparison measures routing flips, not the step."""
    tcfg = get_config(ARCH).reduced(dtype=torch.float32)
    rcfg = ref_get_config(ARCH).reduced(dtype=jnp.float32)
    gen = torch.Generator().manual_seed(0)
    np_params = tree_map(_np, model_init(tcfg, gen, device="cpu"))
    tok = np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 16))
    batch = {"tokens": tok.astype(np.int32),
             "labels": np.roll(tok, -1, 1).astype(np.int32)}
    rp = jax.tree.map(jnp.asarray, np_params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(ref_step.make_train_step(
        rcfg, ref_adamw.AdamWConfig(lr=1e-3)))
    new_state, metrics = step(ref_step.train_state_init(rp), jb)
    logits, aux = jax.jit(ref_forward, static_argnums=2)(
        rp, {"tokens": jb["tokens"]}, rcfg)
    return {"tcfg": tcfg, "np_params": np_params, "batch": batch,
            "logits": np.asarray(logits), "aux": float(aux),
            "new_state": jax.device_get(new_state),
            "metrics": jax.device_get(metrics)}


def test_reduced_deepseek_forward_equals_reference(deepseek):
    """Logits and aux at float32 tolerance, params carried across by
    ``from_jax_params`` (which checks the latent width)."""
    c = deepseek
    tparams = from_jax_params(c["np_params"], c["tcfg"], device="cpu")
    got, gaux = forward_train(
        tparams, {"tokens": torch.from_numpy(c["batch"]["tokens"])},
        c["tcfg"])
    np.testing.assert_allclose(got.detach().numpy(), c["logits"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(gaux), c["aux"], rtol=1e-5, atol=1e-9)
    bad = replace(c["tcfg"], kv_lora_rank=8)
    with pytest.raises(ValueError, match="wkv_a"):
        from_jax_params(c["np_params"], bad, device="cpu")


def test_reduced_deepseek_train_step_within_step_tol(deepseek):
    """One AdamW step of the reduced DeepSeek, port vs reference: loss,
    grad norm, first moments and params within ``STEP_TOL``."""
    c = deepseek
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


def test_coded_kv_serve_keeps_the_latent_cache_raw():
    """``kv_mode="coded"`` codes only ``{k, v, pos}`` nodes, so the
    reduced DeepSeek's latent caches pass through raw, as in the
    reference's store: the tokens are the raw engine's, no segment is
    coded, the ledger's coded bits are its raw bits, and the port's and
    the reference's stores count the same raw bits for the same
    caches."""
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
    assert not eng._kv._segments
    assert totals["kv_hbm_coded_bits"] == totals["kv_hbm_raw_bits"] > 0
    kv = CodedKVStore(codec="huffman", device="cpu")
    rkv = RefKV(codec="huffman")
    assert kv.ingest(init_caches(tcfg, 2, 16, device="cpu")) == 0
    assert rkv.ingest(ref_init_caches(ref_get_config(ARCH).reduced(), 2,
                                      16)) == 0
    assert kv.kv_hbm_raw_bits == kv.kv_hbm_coded_bits == \
        rkv.kv_hbm_raw_bits == rkv.kv_hbm_coded_bits > 0
