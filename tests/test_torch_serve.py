"""Port parity, serve slice: the torch model and engine against the JAX
reference on a tiny dense config, on the CPU.

Weights come from the reference's ``model_init`` and reach the port
through ``models.convert.from_jax_params``.  Logits agree within
rtol/atol 1e-4 (float32; the two frameworks sum in different orders);
greedy tokens are equal; the bitexact wire's coded and decoded bits are
equal to the reference's on the same logits.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.codebook import build_codebook as ref_build  # noqa: E402
from repro.comm.compression import CompressionSpec as RefSpec  # noqa: E402
from repro.models import (BlockGroup as RefGroup,  # noqa: E402
                          ModelConfig as RefConfig)
from repro.models import (decode_step as ref_decode,  # noqa: E402
                          forward_train as ref_forward,
                          model_init as ref_init, prefill as ref_prefill)
from repro.serve.engine import (Engine as RefEngine,  # noqa: E402
                                ServeConfig as RefServe,
                                make_serve_step as ref_serve_step)

from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.models import (BlockGroup, ModelConfig,  # noqa: E402
                                decode_step, forward, model_init, prefill)
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve.engine import (Engine, ServeConfig,  # noqa: E402
                                      make_activation_probe)

torch.set_num_threads(1)

# Jitted reference functions: one compile each, shared by every test.
ref_init = jax.jit(ref_init, static_argnums=0)
ref_forward = jax.jit(ref_forward, static_argnums=2)
ref_prefill = jax.jit(ref_prefill, static_argnums=(2, 3))
ref_decode = jax.jit(ref_decode, static_argnums=4)

TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(d_model=64, vocab_size=128, n_heads=2, n_kv_heads=1, head_dim=32,
          d_ff=128, ffn_activation="gelu", tie_embeddings=True)


@functools.lru_cache(maxsize=None)
def _pair(kind="attn", window=0):
    """(reference cfg, port cfg, reference params, port params)."""
    extra = {"sliding_window": window}
    rcfg = RefConfig(name="t", arch_type="dense",
                     blocks=(RefGroup((kind,), 2),), remat="none",
                     dtype=jnp.float32, **KW, **extra)
    tcfg = ModelConfig(name="t", arch_type="dense",
                       blocks=(BlockGroup((kind,), 2),), dtype=torch.float32,
                       **KW, **extra)
    rparams = ref_init(rcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.device_get(rparams), tcfg, device="cpu")
    return rcfg, tcfg, rparams, tparams


def _tokens(seed, b=2, s=8):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("kind,window", [("attn", 0), ("local", 4)])
def test_prefill_and_decode_logits_match_reference(kind, window):
    rcfg, tcfg, rparams, tparams = _pair(kind, window)
    tok = _tokens(1, s=10)
    want_fwd, _ = ref_forward(rparams, {"tokens": jnp.asarray(tok)}, rcfg)
    got_fwd = forward(tparams, {"tokens": torch.from_numpy(tok).long()},
                      tcfg)
    np.testing.assert_allclose(got_fwd.numpy(), np.asarray(want_fwd), **TOL)

    want, rc = ref_prefill(rparams, {"tokens": jnp.asarray(tok[:, :6])},
                           rcfg, 16)
    head = torch.from_numpy(tok[:, :6]).long()
    got, tc = prefill(tparams, {"tokens": head}, tcfg, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for t in range(6, 10):
        want, rc = ref_decode(rparams, jnp.asarray(tok[:, t:t + 1]), rc,
                              jnp.int32(t), rcfg)
        step_tok = torch.from_numpy(tok[:, t:t + 1]).long()
        got, tc = decode_step(tparams, step_tok, tc, t, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got[:, 0].numpy(),
                                   got_fwd[:, t].numpy(), **TOL)


def test_greedy_generate_tokens_equal_reference():
    rcfg, tcfg, rparams, tparams = _pair()
    tok = _tokens(2)
    want, _ = RefEngine(rparams, rcfg, RefServe(max_cache_len=32)).generate(
        jnp.asarray(tok), 6)
    got, totals = Engine(tparams, tcfg, ServeConfig(max_cache_len=32),
                         device="cpu").generate(tok, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert totals["act_decode_mismatch"] == 0.0


def _books(pkg_build, logits_bf16_u16):
    lo = np.bincount(logits_bf16_u16 & 0xFF, minlength=256)
    hi = np.bincount(logits_bf16_u16 >> 8, minlength=256)
    return {"lo": pkg_build(lo, codec="huffman"),
            "hi": pkg_build(hi, codec="huffman")}


@pytest.mark.parametrize("backend", ["multisym", "scan"])
def test_bitexact_wire_bits_equal_reference_on_same_logits(backend):
    rcfg, tcfg, rparams, tparams = _pair()
    tok = _tokens(3)
    logits, caches = ref_prefill(rparams, {"tokens": jnp.asarray(tok)},
                                 rcfg, 16)
    u16 = np.asarray(logits.astype(jnp.bfloat16)).view(np.uint16).reshape(-1)
    kw = dict(mode="bitexact", transport="chunked", chunk=64,
              decode_backend=backend)
    rspec = RefSpec.from_books(_books(ref_build, u16), "bf16", **kw)
    tspec = CompressionSpec.from_books(_books(build_codebook, u16), "bf16",
                                       **kw)
    assert tspec.plane_lengths == rspec.plane_lengths
    step = jax.jit(ref_serve_step(rcfg, rspec))
    nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    rlogits, _, rm = step(rparams, nxt, caches, jnp.int32(tok.shape[1]))
    tm = make_activation_probe(tspec)(
        torch.from_numpy(np.array(rlogits, np.float32)))
    assert float(tm["act_decode_mismatch"]) == 0.0
    for k in ("act_raw_bits", "act_coded_bits", "act_decoded_bits",
              "act_decode_chunks"):
        assert float(tm[k]) == float(rm[k]), k
    assert float(tm["act_decoded_bits"]) == float(tm["act_coded_bits"])
    for plane in ("lo", "hi"):
        np.testing.assert_array_equal(tm[f"act_hist_{plane}"].numpy(),
                                      np.asarray(rm[f"act_hist_{plane}"]))

    # The whole port engine on the same spec: every step lossless.
    eng = Engine(tparams, tcfg, ServeConfig(max_cache_len=16), tspec,
                 device="cpu")
    _, totals = eng.generate(tok, 4)
    assert totals["act_decode_mismatch"] == 0.0
    assert totals["act_decode_chunks"] == 3 * 2 * 4   # steps × planes × NB
    assert totals["act_decoded_bits"] == totals["act_coded_bits"] > 0


def test_engine_refuses_unported_options():
    _, tcfg, _, tparams = _pair()
    sc = ServeConfig(max_cache_len=16)
    # a lifecycle manager needs a spec, as in the reference
    with pytest.raises(ValueError, match="needs a comp_spec"):
        Engine(tparams, tcfg, sc, device="cpu", lifecycle=object())
    with pytest.raises(NotImplementedError, match="A8"):
        Engine(tparams, tcfg, sc, device="cpu", ep_degree=2)
    eng = Engine(tparams, tcfg, sc, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        eng.generate(_tokens(4), 2, prefix_embeds=torch.zeros(2, 1, 64))
    with pytest.raises(NotImplementedError, match="A8"):
        model_init(ModelConfig(name="m", arch_type="moe", d_model=8,
                               vocab_size=8,
                               blocks=(BlockGroup(("attn_moe",), 1),)),
                   torch.Generator(), device="cpu")
