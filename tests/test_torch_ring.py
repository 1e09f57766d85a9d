"""Port parity, compressed rings: ``repro_torch.comm.ring`` and
``hierarchy`` on a ``LoopbackAxis`` against the reference's rings run in
this process under ``jax.vmap(..., axis_name=...)`` (nested for the
two-axis hierarchy), jitted.  The loopback stacks the ranks on leading
dims exactly as vmap does, so results, every stat (``hop_coded_bits``
hop by hop) and the first hop's words compare bit for bit.  Each
reference runs once per module (a fixture); the reference decodes with
``scan`` where the case does not name its backend (the codec is lossless,
so the result does not depend on it) and the port with ``auto`` and
``scan``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm import (hierarchical_all_reduce as ref_hier,  # noqa: E402
                        ring_all_gather as ref_ag, ring_all_reduce as ref_ar,
                        ring_all_to_all as ref_a2a,
                        ring_reduce_scatter as ref_rs)
from repro.core.codebook import build_codebook as ref_build  # noqa: E402
from repro.core.encoder import encode_chunked_jit  # noqa: E402

from repro_torch.comm import (LoopbackAxis, hierarchical_all_reduce,  # noqa
                              loopback_mesh, ring_all_gather, ring_all_reduce,
                              ring_all_to_all, ring_reduce_scatter)
from repro_torch.comm.wire import peer_sum, rank_sum, wire_add  # noqa
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.core.symbols import SCHEMES  # noqa: E402

torch.set_num_threads(1)

CHUNK = 64
F8 = ml_dtypes.float8_e4m3fn
TDT = {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn}
JDT = {"bf16": jnp.bfloat16, "e4m3": jnp.float8_e4m3fn}


def _data(kind, scheme, shape, seed):
    """Seeded payload as a numpy array of the wire dtype."""
    rng = np.random.default_rng(seed)
    if kind == "int":
        v = rng.integers(-3, 4, size=shape).astype(np.float32)
    elif kind == "gauss":                     # spread exponents
        v = (rng.standard_normal(shape)
             * np.exp2(rng.integers(-6, 7, size=shape))).astype(np.float32)
    else:                                     # every e4m3 pattern, NaN too
        return rng.integers(0, 256, size=shape, dtype=np.uint8).view(F8)
    return v.astype(ml_dtypes.bfloat16 if scheme == "bf16" else F8)


def _torch(a):
    if a.dtype == F8:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _bits(a):
    """Bit patterns of a wire-dtype array or tensor, as numpy ints."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8 if a.dtype == torch.float8_e4m3fn
                   else torch.int16).numpy()
    else:
        a = np.asarray(a)
        a = a.view(np.uint8 if a.dtype == F8 else np.int16)
    return a.astype(np.int64)


def _books(x, scheme, codec):
    """Books built in both packages from the same counts; their lengths
    and codes must agree before any stream is compared."""
    planes = SCHEMES[scheme].to_symbols(_torch(x))
    rb, tb = {}, {}
    for p, s in planes.items():
        counts = np.bincount(s.numpy()[::2], minlength=256)
        rb[p] = ref_build(counts, codec=codec)
        tb[p] = build_codebook(counts, codec=codec)
        np.testing.assert_array_equal(rb[p].lengths, tb[p].lengths)
        np.testing.assert_array_equal(rb[p].codes, tb[p].codes)
    return rb, tb


def _ref(fn, x, nested=False):
    f = jax.vmap(fn, axis_name="r")
    if nested:
        f = jax.vmap(jax.vmap(fn, axis_name="i"), axis_name="o")
    return jax.tree.map(np.asarray, jax.jit(f)(jnp.asarray(x)))


def _same(ref, got):
    """Result bit patterns and every stat equal."""
    (ry, rs), (ty, ts) = ref, got
    np.testing.assert_array_equal(_bits(ty), _bits(ry).reshape(
        _bits(ty).shape))
    assert set(rs) == set(ts)
    for k in rs:
        np.testing.assert_array_equal(ts[k].numpy(),
                                      np.asarray(rs[k], np.float64), k)


class _Recording(LoopbackAxis):
    """A loopback axis that keeps every tensor it moves."""

    def __init__(self, n):
        super().__init__(n)
        self.sent = []

    def ppermute(self, tensors, shift):
        self.sent.append(tensors)
        return super().ppermute(tensors, shift)


# ------------------------------------------------ reference runs (once)
def _case_int():
    n = 4
    x = _data("int", "bf16", (n, 4 * 97), 0)       # segments of 97: ragged
    rb, tb = _books(x, "bf16", "huffman")

    def body(v):
        kw = dict(chunk=CHUNK, decode_backend="scan")
        return (ref_ar(v, "r", rb, "bf16", **kw),
                ref_rs(v, "r", rb, "bf16", **kw),
                ref_ag(v, "r", rb, "bf16", **kw),
                ref_a2a(v.reshape(n, -1), "r", rb, "bf16", **kw))
    return x, tb, _ref(body, x)


def _case_gauss_qlc():
    x = _data("gauss", "bf16", (2, 256), 1)        # whole chunks: no mask
    rb, tb = _books(x, "bf16", "qlc")

    def body(v):
        return tuple(ref_ar(v, "r", rb, "bf16", chunk=CHUNK, carry=c)
                     for c in ("wire", "f32"))
    return x, tb, _ref(body, x)


def _case_e4m3():
    x = _data("e4m3", "e4m3", (2, 2 * 150), 2)
    rb, tb = _books(x, "e4m3", "huffman")

    def body(v):                                   # the reference's auto
        return (ref_ar(v, "r", rb, "e4m3", chunk=CHUNK),
                ref_ar(v, "r", rb, "e4m3", chunk=CHUNK, carry="f32"),
                ref_rs(v, "r", rb, "e4m3", chunk=CHUNK))
    return x, tb, _ref(body, x)


def _case_hier():
    x = _data("int", "bf16", (2, 2, 2 * 75), 3)
    rb, tb = _books(x, "bf16", "huffman")

    def body(v):
        return ref_hier(v, ("i", "o"), rb, "bf16", chunk=CHUNK,
                        decode_backend="scan")
    return x, tb, _ref(body, x, nested=True)


def _case_pallas():
    x = _data("gauss", "e4m3", (2, 130), 4)
    rb, tb = _books(x, "e4m3", "qlc")

    def body(v):
        return ref_ag(v, "r", rb, "e4m3", chunk=CHUNK,
                      decode_backend="pallas")
    return x, tb, _ref(body, x)


@pytest.fixture(scope="module")
def case_int():
    return _case_int()


@pytest.fixture(scope="module")
def case_gauss_qlc():
    return _case_gauss_qlc()


@pytest.fixture(scope="module")
def case_e4m3():
    return _case_e4m3()


@pytest.fixture(scope="module")
def case_hier():
    return _case_hier()


@pytest.fixture(scope="module")
def case_pallas():
    return _case_pallas()


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("backend", ["auto", "scan"])
def test_ring_family_int_bf16_equals_reference(case_int, backend):
    x, tb, (r_ar, r_rs, r_ag, r_a2a) = case_int
    xt, n = _torch(x), x.shape[0]
    ax = LoopbackAxis(n)
    kw = dict(chunk=CHUNK, decode_backend=backend)
    _same(r_ar, ring_all_reduce(xt, ax, tb, "bf16", **kw))
    _same(r_rs, ring_reduce_scatter(xt, ax, tb, "bf16", **kw))
    _same(r_ag, ring_all_gather(xt, ax, tb, "bf16", **kw))
    _same(r_a2a, ring_all_to_all(xt.reshape(n, n, -1), ax, tb, "bf16", **kw))
    # integer-valued: every ring order is exact
    np.testing.assert_array_equal(np.asarray(r_ar[0], np.float32),
                                  np.broadcast_to(x.astype(np.float32).sum(0),
                                                  x.shape))
    assert r_ar[1]["hop_coded_bits"].shape == (n, 2 * (n - 1))


def test_first_hop_words_equal_reference(case_int):
    """The words ring_all_reduce ships first are the reference's chunked
    encode of each rank's own segment: the padded tail ships no bits."""
    x, tb, _ = case_int
    n, size = x.shape
    seg = -(-size // n)
    ax = _Recording(n)
    ring_all_reduce(_torch(x), ax, tb, "bf16", chunk=CHUNK)
    planes = SCHEMES["bf16"].to_symbols(_torch(x))
    for p, (words, bits) in zip(("lo", "hi"), ax.sent[:2]):
        sym = planes[p].numpy().reshape(n, size)
        for i in range(n):
            rw, rbits = encode_chunked_jit(
                jnp.asarray(sym[i, i * seg:(i + 1) * seg]),
                jnp.asarray(tb[p].codes), jnp.asarray(tb[p].lengths),
                chunk=CHUNK)
            np.testing.assert_array_equal(words[i].numpy().view(np.uint32),
                                          np.asarray(rw), p)
            np.testing.assert_array_equal(bits[i].numpy(), np.asarray(rbits))


@pytest.mark.parametrize("carry", ["wire", "f32"])
def test_ring_all_reduce_gauss_qlc_equals_reference(case_gauss_qlc, carry):
    x, tb, refs = case_gauss_qlc
    got = ring_all_reduce(_torch(x), LoopbackAxis(x.shape[0]), tb, "bf16",
                          chunk=CHUNK, carry=carry)
    _same(refs[("wire", "f32").index(carry)], got)
    if carry == "f32":                         # two components a hop
        wire = refs[0][1]["raw_wire_bits"]
        np.testing.assert_array_equal(got[1]["raw_wire_bits"].numpy(),
                                      2 * np.asarray(wire, np.float64))


@pytest.mark.parametrize("op", ["all_reduce", "all_reduce_f32",
                                "reduce_scatter"])
def test_e4m3_ring_past_448_equals_reference(case_e4m3, op):
    """Sums past the e4m3 range give the reference's NaN bit patterns."""
    x, tb, (r_ar, r_f32, r_rs) = case_e4m3
    xt, ax = _torch(x), LoopbackAxis(x.shape[0])
    if op == "all_reduce":
        got, want = ring_all_reduce(xt, ax, tb, "e4m3", chunk=CHUNK), r_ar
        total = x.astype(np.float32).sum(0)
        assert np.isnan(np.asarray(want[0], np.float32)[0][
            np.abs(total) > 464]).all()
    elif op == "all_reduce_f32":
        got, want = ring_all_reduce(xt, ax, tb, "e4m3", chunk=CHUNK,
                                    carry="f32"), r_f32
    else:
        got, want = ring_reduce_scatter(xt, ax, tb, "e4m3", chunk=CHUNK), r_rs
    _same(want, got)


def test_hierarchical_ring_equals_reference(case_hier):
    x, tb, ref = case_hier
    mesh = loopback_mesh({"outer": 2, "inner": 2})
    got = hierarchical_all_reduce(_torch(x), (mesh["inner"], mesh["outer"]),
                                  tb, "bf16", chunk=CHUNK,
                                  decode_backend="scan")
    _same(ref, got)
    np.testing.assert_array_equal(
        np.asarray(ref[0], np.float32),
        np.broadcast_to(x.astype(np.float32).sum((0, 1)), x.shape))


def test_ring_all_gather_matches_pallas_reference(case_pallas):
    x, tb, ref = case_pallas
    _same(ref, ring_all_gather(_torch(x), LoopbackAxis(2), tb, "e4m3",
                               chunk=CHUNK, decode_backend="pallas"))


def test_wire_adds_equal_xla():
    """The pinned adds: e4m3 pairs past 448 (XLA's NaN, where torch's own
    conversion saturates) and NaN operands; bf16 and e4m3 endpoint peer
    sums over 4 peers (XLA's ``sum(axis=0)``: bf16 in float32 rounded
    once, e4m3 add by add) and psums (add by add in rank order)."""
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 256, 4000, dtype=np.uint8).view(F8)
            for _ in range(2))
    want = np.asarray(jax.jit(jnp.add)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_bits(wire_add(_torch(a), _torch(b))),
                                  _bits(want))
    for scheme, kind in (("bf16", "gauss"), ("e4m3", "e4m3")):
        g = _data(kind, scheme, (4, 3000), 6)
        want = np.asarray(jax.jit(lambda v: v.sum(axis=0))(jnp.asarray(g)))
        np.testing.assert_array_equal(_bits(peer_sum(_torch(g), 0)),
                                      _bits(want), scheme)
        want = np.asarray(jax.jit(jax.vmap(lambda v: jax.lax.psum(v, "r"),
                                           axis_name="r"))(jnp.asarray(g)))
        np.testing.assert_array_equal(_bits(rank_sum(_torch(g), 0)),
                                      _bits(want[0]), scheme)
