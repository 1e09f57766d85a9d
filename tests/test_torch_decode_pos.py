"""Port parity: the decode step with its position on the device.

``serve.CapturedStep`` replays a CUDA graph of the decode step with the
position in a device buffer, so ``decode_step`` takes ``pos`` as a 0-d
int32 tensor as well as an int.  Here, on the CPU, for every block kind
on the tiny configs of the other ``test_torch_*`` files (float32, two
layers): the tensor position gives the int position's logits and caches
bit for bit, and both follow the reference's ``decode_step`` under
``jax.jit`` with a traced ``jnp.int32`` position (logits within 1e-4 as
``test_torch_serve.py`` holds them; positions and MoE counts equal).
The steps start from a 4-token prefill, so a windowed kind's 4-slot ring
wraps.  On the ``meta`` device, where any op that reads a value back to
the host raises, the step runs to the end for every block kind and for
the registered decode configs at full width: nothing in it stops a
graph capture.  The engine's CPU path (the plain step) keeps the
reference's tokens and bits in ``test_torch_serve.py``.
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
from repro.models import decode_step as ref_decode  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import (BlockGroup,  # noqa: E402
                                ModelConfig, decode_step, init_caches,
                                model_init, prefill)
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.blocks import BLOCK_KINDS  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.engine import (CapturedStep, Engine,  # noqa: E402
                                      ServeConfig, make_serve_step)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
HEAD, STEPS, CACHE = 4, 6, 16          # prefill, decode steps, cache slots
WINDOW = 4
# the tiny configs of test_torch_serve / _mla / _moe / _rglru / _ssm
ATTN = dict(vocab_size=128, n_heads=2, n_kv_heads=1, head_dim=32,
            ffn_activation="gelu", tie_embeddings=True)
MLA = dict(vocab_size=128, n_heads=4, q_lora_rank=32, kv_lora_rank=16,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
# capacity 4 a sequence up to 32 tokens: a decode of 10 tokens drops slots
MOE = dict(n_experts=4, experts_per_token=2, moe_d_ff=64,
           capacity_factor=0.5)
REC = dict(vocab_size=32, lru_width=64)
MAMBA = dict(vocab_size=32, ssm_state=16, ssm_head_dim=32, ssm_chunk=8)

_ref_decode = jax.jit(ref_decode, static_argnums=4)


def _kw(kind):
    """The tiny config's fields for ``kind``."""
    kw = dict(d_model=64, d_ff=128, remat="none")
    if kind.startswith("mla"):
        kw.update(MLA)
    elif kind == "rec":
        kw.update(REC)
    elif kind == "mamba":
        kw.update(MAMBA)
    else:
        kw.update(ATTN)
    if "moe" in kind:
        kw.update(MOE)
    if "local" in kind:
        kw["sliding_window"] = WINDOW
    return kw


@functools.lru_cache(maxsize=None)
def _pair(kind):
    """(reference cfg, port cfg, reference params, port params)."""
    kw = _kw(kind)
    rcfg = RefConfig(name="t", arch_type="x", blocks=(RefGroup((kind,), 2),),
                     dtype=jnp.float32, **kw)
    tcfg = ModelConfig(name="t", arch_type="x",
                       blocks=(BlockGroup((kind,), 2),), dtype=torch.float32,
                       **kw)
    params = model_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    rparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    return rcfg, tcfg, rparams, params


def _bits_equal(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _run(kind, seed=1):
    """The three decodes of ``STEPS`` tokens after a ``HEAD``-token
    prefill: (port caches by int, by tensor, reference caches), checked
    step by step."""
    rcfg, tcfg, rparams, params = _pair(kind)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, tcfg.vocab_size, (2, HEAD + STEPS)))
    _, by_int = prefill(params, {"tokens": tok[:, :HEAD]}, tcfg, CACHE)
    by_tensor = tree_map(torch.clone, by_int)
    # copies: jnp.asarray may share a CPU buffer, which the port's decode
    # writes in place
    rc = jax.tree.map(lambda t: jnp.array(t.numpy(), copy=True), by_int)
    for t in range(HEAD, HEAD + STEPS):
        step = tok[:, t:t + 1]
        got_i, by_int = decode_step(params, step, by_int, t, tcfg)
        got_t, by_tensor = decode_step(
            params, step, by_tensor, torch.tensor(t, dtype=torch.int32), tcfg)
        want, rc = _ref_decode(rparams, jnp.asarray(step.numpy(), jnp.int32),
                               rc, jnp.int32(t), rcfg)
        assert _bits_equal(got_t, got_i), t
        for a, b in zip(tree_leaves(by_tensor), tree_leaves(by_int)):
            assert _bits_equal(a, b), t
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want), **TOL)
        for a, b in zip(tree_leaves(by_tensor), jax.tree.leaves(rc)):
            if a.dtype == torch.int32:        # positions and MoE counts
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    return by_int, by_tensor, rc


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_tensor_pos_equals_int_pos_and_reference(kind):
    by_int, _, _ = _run(kind)
    if "local" in kind:         # the ring wrapped: it holds the last window
        c = by_int[0][0]
        pos = (c["mixer"] if "moe" in kind else c)["pos"]   # (layers, slots)
        assert sorted(pos[0].tolist()) == list(range(HEAD + STEPS - WINDOW,
                                                     HEAD + STEPS))


@pytest.mark.parametrize("kind", [k for k in BLOCK_KINDS if "moe" in k])
def test_moe_counts_after_decode_equal_int_path(kind):
    """The routed totals after the decode run are the int path's and the
    reference's, and past the capacity of the whole sequence: slots were
    dropped on the way."""
    _, tcfg, _, _ = _pair(kind)
    by_int, by_tensor, rc = _run(kind, seed=2)
    got, want = by_tensor[0][0]["moe_counts"], by_int[0][0]["moe_counts"]
    assert got.dtype == torch.int32 and torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rc[0][0]["moe_counts"]))
    assert int(got.sum()) == 2 * 2 * (HEAD + STEPS) * tcfg.experts_per_token
    assert int(got.max()) > moe.moe_stream_capacity_host(HEAD + STEPS, tcfg)


def _moe_cfgs():
    """The registered MoE configs and the tiny one."""
    cfgs = [get_config(a) for a in ARCH_IDS if get_config(a).n_experts]
    return cfgs + [_pair("attn_moe")[1]]


@pytest.mark.parametrize("cfg", _moe_cfgs(), ids=lambda c: c.name)
def test_stream_capacity_on_device_equals_host(cfg):
    """``moe_stream_capacity(pos + 1)`` from an int32 position tensor,
    as ``moe_decode`` takes it, is ``moe_stream_capacity_host(pos + 1)``
    for every position 0..4096, and the reference's."""
    p = torch.arange(4097, dtype=torch.int32)
    got = moe.moe_stream_capacity(p + 1, cfg)
    want = [moe.moe_stream_capacity_host(i + 1, cfg) for i in range(4097)]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (0, 7, 255, 4096):
        one = moe.moe_stream_capacity(torch.tensor(i, dtype=torch.int32) + 1,
                                      cfg)
        assert one.dim() == 0 and int(one) == want[i]
    if cfg.name == "t":
        rcfg = _pair("attn_moe")[0]
        ref = ref_moe.moe_stream_capacity(jnp.arange(1, 4098), rcfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _meta_step(cfg, batch=2, cache_len=8):
    params = model_init(cfg, None, device="meta")
    caches = init_caches(cfg, batch, cache_len, device="meta")
    tok = torch.zeros((batch, 1), dtype=torch.int64, device="meta")
    pos = torch.zeros((), dtype=torch.int32, device="meta")
    logits, out = decode_step(params, tok, caches, pos, cfg)
    assert logits.device.type == "meta"
    assert tuple(logits.shape) == (batch, 1, cfg.vocab_size)
    assert out is caches


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_decode_step_reads_nothing_back_on_meta(kind):
    """Every op of the step runs on meta tensors, where ``.item()``,
    ``bool()`` or a copy to the host raises."""
    _meta_step(_pair(kind)[1])


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if not get_config(a).prefix_only])
def test_full_width_decode_step_on_meta(arch):
    """The registered decode configs at full width, on meta, each block
    group's depth cut to one repeat."""
    cfg = get_config(arch)
    _meta_step(replace(cfg, blocks=tuple(replace(bg, repeats=1)
                                         for bg in cfg.blocks)))


@pytest.mark.parametrize("backend", ["multisym", "scan"])
def test_serve_step_tensor_pos_equals_int_pos(backend):
    """``make_serve_step`` (the captured step's plain version) with the
    bitexact wire: the tensor position's logits, caches and metrics are
    the int position's; the CPU engine runs this plain step."""
    from repro_torch.comm.compression import CompressionSpec
    from repro_torch.core.codebook import build_codebook
    _, tcfg, _, params = _pair("local")
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, 128, (2, 8)))
    logits, caches = prefill(params, {"tokens": tok}, tcfg, CACHE)
    u16 = logits.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    books = {p: build_codebook(np.bincount(v.reshape(-1), minlength=256))
             for p, v in (("lo", u16 & 0xFF), ("hi", u16 >> 8))}
    spec = CompressionSpec.from_books(books, "bf16", mode="bitexact",
                                      transport="chunked", chunk=64,
                                      decode_backend=backend)
    step = make_serve_step(tcfg, spec)
    nxt = logits[:, -1].argmax(-1)[:, None]
    other = tree_map(torch.clone, caches)
    li, ci, mi = step(params, nxt, caches, 8)
    lt, ct, mt = step(params, nxt, other, torch.tensor(8, dtype=torch.int32))
    assert _bits_equal(lt, li)
    for a, b in zip(tree_leaves(ct), tree_leaves(ci)):
        assert _bits_equal(a, b)
    assert sorted(mt) == sorted(mi)
    for k in mi:
        assert _bits_equal(mt[k], mi[k]), k
    assert float(mt["act_decode_mismatch"]) == 0.0
    eng = Engine(params, tcfg, ServeConfig(max_cache_len=CACHE), spec,
                 device="cpu")
    assert not isinstance(eng._step, CapturedStep)


def test_launch_accounting_and_private_accumulators():
    """A replay adds the launches its capture counted; a capture's
    accumulators are keyed by their owner, eager calls' by None."""
    before = dict(build.LAUNCHES)
    try:
        build.add_launches({"encode_lookup": 3, "histogram256": 2})
        build.add_launches({"encode_lookup": -1})
        assert build.LAUNCHES["encode_lookup"] == before["encode_lookup"] + 2
        assert build.LAUNCHES["histogram256"] == before["histogram256"] + 2
    finally:
        build.LAUNCHES.update(before)
    assert build.accumulator_key(0, 7) == (0, 7, None)
    with build.private_accumulators("a"):
        assert build.accumulator_key(0, 7) == (0, 7, "a")
        with build.private_accumulators("b"):
            assert build.accumulator_key(1, 7) == (1, 7, "b")
        assert build.accumulator_key(0, 7) == (0, 7, "a")
    assert build.accumulator_key(0, 7) == (0, 7, None)
