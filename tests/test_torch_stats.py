"""Port parity, the paper's measurement core: the seven symbol schemes,
the shard statistics behind Figs. 2–4 and the two encoders the paper
compares, against the JAX reference on the CPU.

Symbol planes, shard histograms, books, per-shard reports, words and
bit counts are held equal (bytes and integers exactly; the reports'
float64 arrays too: both packages compute them with the same numpy
code from equal histograms).  Inputs are numpy-seeded, with the special
values of each format: NaN of either sign, ±inf, ±0, subnormals of
float32, bf16 and e5m2, values past each format's largest finite value.
"""
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import stats as ref_stats  # noqa: E402
from repro.core import symbols as ref_symbols  # noqa: E402
from repro.core.codebook import CodebookRegistry as RefRegistry  # noqa: E402
from repro.core.encoder import (  # noqa: E402
    encoded_size_bits as ref_size_bits,
    single_stage_encode as ref_single, three_stage_encode as ref_three)

from repro_torch.core import (ShardStatsCollector, encoded_size_bits,  # noqa
                              per_shard_report, shard_histograms,
                              single_stage_encode, three_stage_encode)
from repro_torch.core import symbols  # noqa: E402
from repro_torch.core.codebook import CodebookRegistry  # noqa: E402

torch.set_num_threads(1)

SCHEMES = ("bf16", "f32", "e4m3", "e5m2", "e3m2", "e2m3", "e2m1")
SPECIALS = np.array(
    [np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40, 2.0 ** -16,
     2.0 ** -17, 3 * 2.0 ** -17, -2.0 ** -15, 1e-10, 6.0, 6.5, 7.5, 28.0,
     30.0, 31.0, 448.0, 460.0, 464.0, 465.0, 470.0, -500.0, 57344.0,
     60000.0, 61439.0, 61440.0, 65504.0, -1e6, 3e38, -3.4e38],
    dtype=np.float32)


def _values(seed=0, n=4096):
    """Seeded values over many binades, with every special."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
    return np.concatenate([x.astype(np.float32), SPECIALS])


def _bf16(x):
    """(ml_dtypes bf16 array, the same bits as a torch bf16 tensor)."""
    b = x.astype(ml_dtypes.bfloat16)
    return b, torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)


# ---------------------------------------------------------------- schemes
@pytest.mark.parametrize("name", SCHEMES)
def test_scheme_planes_equal_reference_bytes(name):
    """Every scheme's planes are the reference's bytes, specials
    included, from float32 and from bf16 inputs (XLA's casts: a NaN to
    bf16 is 0x7FC0 with its sign, to e5m2 0x7E; e4m3 past 464 is NaN)."""
    got_s, want_s = symbols.SCHEMES[name], ref_symbols.SCHEMES[name]
    for attr in ("planes", "symbol_bits", "n_symbols"):
        assert getattr(got_s, attr) == getattr(want_s, attr)
    x = _values()
    xb, tb = _bf16(x)
    for want_in, got_in in ((x, torch.from_numpy(x)), (xb, tb)):
        got, want = got_s.to_symbols(got_in), want_s.to_symbols(want_in)
        assert list(got) == list(want) == list(got_s.planes)
        for p in want:
            assert got[p].dtype == torch.uint8
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want[p]))
    assert got_s.total_symbol_bits() == want_s.total_symbol_bits()


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
def test_xla_cast_equals_reference_casts(dtype):
    """``xla_cast`` gives XLA's bytes for a float32 cast, specials
    included, and is the one rule the wire and the KV caches use."""
    import jax.numpy as jnp

    from repro_torch.comm import wire
    from repro_torch.models import layers

    assert wire.to_wire is layers.cache_cast is symbols.xla_cast
    x = _values(3)
    want = np.asarray(jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = symbols.xla_cast(torch.from_numpy(x), getattr(torch, dtype))
    ints = np.int16 if dtype == "bfloat16" else np.uint8
    np.testing.assert_array_equal(
        got.view(torch.int16 if ints is np.int16 else torch.uint8).numpy(),
        want.view(ints))


@pytest.mark.parametrize("e,m", [(3, 2), (2, 3), (2, 1)])
def test_exmy_tables_and_round_trip_equal_reference(e, m):
    np.testing.assert_array_equal(symbols.exmy_values(e, m),
                                  ref_symbols.exmy_values(e, m))
    for got, want in zip(symbols._exmy_tables(e, m),
                         ref_symbols._exmy_tables(e, m)):
        np.testing.assert_array_equal(got, want)
    vals = symbols.exmy_values(e, m)
    mids = (vals[:-1] + vals[1:]) / 2            # ties between neighbours
    x = np.concatenate([_values(1).astype(np.float64), vals, mids])
    got = symbols.exmy_quantize(torch.from_numpy(x), e, m)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_symbols.exmy_quantize(x, e, m))
    np.testing.assert_array_equal(
        symbols.exmy_dequantize(got, e, m).numpy(),
        ref_symbols.exmy_dequantize(got.numpy(), e, m))


def test_scheme_for_dtype_equals_reference():
    for tdt, jdt in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32"),
                     (torch.float8_e4m3fn, "float8_e4m3fn"),
                     (torch.float8_e5m2, "float8_e5m2")):
        want = ref_symbols.scheme_for_dtype(getattr(ml_dtypes, jdt, jdt))
        assert symbols.scheme_for_dtype(tdt).name == want.name
    with pytest.raises(KeyError):
        symbols.scheme_for_dtype(torch.int8)
    with pytest.raises(KeyError):
        ref_symbols.scheme_for_dtype(np.int8)
    # an fp8 tensor's planes are its own bytes
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        t = torch.from_numpy(_values(2)).to(dt)
        (plane,) = symbols.scheme_for_dtype(dt).to_symbols(t).values()
        assert torch.equal(plane, t.view(torch.uint8))


# ------------------------------------------------------- shard statistics
@pytest.mark.parametrize("name,layers,shards", [("bf16", 4, 8),
                                                ("bf16", 1, 16),
                                                ("e3m2", 2, 4)])
def test_shard_histograms_equal_reference(name, layers, shards):
    x = np.random.default_rng(3).standard_normal((layers, 48, 64)).astype(
        np.float32)
    xb, tb = _bf16(x)
    want = ref_stats.shard_histograms(xb, ref_symbols.SCHEMES[name], shards,
                                      layer_axis_len=layers)
    got = shard_histograms(tb, symbols.SCHEMES[name], shards,
                           layer_axis_len=layers)
    assert list(got) == list(want)
    for p in want:
        assert got[p].dtype == want[p].dtype == np.int64
        assert got[p].shape == (layers * shards,
                                symbols.SCHEMES[name].n_symbols)
        np.testing.assert_array_equal(got[p], want[p])
    with pytest.raises(ValueError, match="not divisible"):
        shard_histograms(tb, symbols.SCHEMES[name], 7, layer_axis_len=layers)


@pytest.mark.parametrize("with_registry", [False, True])
def test_collector_books_and_report_equal_reference(with_registry):
    """Three captures of two kinds: histograms, average counts, the
    books the collector builds (or feeds a given registry), and the
    per-shard report against the average book, all equal."""
    rng = np.random.default_rng(4)
    got_c = ShardStatsCollector(n_shards=4, registry=(
        CodebookRegistry() if with_registry else None))
    want_c = ref_stats.ShardStatsCollector(n_shards=4, registry=(
        RefRegistry() if with_registry else None))
    for step in range(3):
        for kind, scale in (("ffn1_act", 1.0), ("grad", 1e-3)):
            xb, tb = _bf16((rng.standard_normal((2, 32, 64)) * scale)
                           .astype(np.float32))
            got_c.capture(kind, tb, layer_axis_len=2)
            want_c.capture(kind, xb, layer_axis_len=2)
    for key in (("ffn1_act", "hi"), ("grad", "lo")):
        np.testing.assert_array_equal(got_c.histograms(*key),
                                      want_c.histograms(*key))
        np.testing.assert_array_equal(got_c.average_counts(*key),
                                      want_c.average_counts(*key))
    got_reg, want_reg = got_c.build_codebooks(), want_c.build_codebooks()
    if with_registry:
        # the reference passes over its empty registry (falsy) for a new
        # empty one; the port rebuilds the one it was given
        assert len(want_reg) == 0 and want_reg is not want_c.registry
        assert got_reg is got_c.registry
        want_reg = want_c.registry
        want_reg.rebuild()
    assert got_reg.book_epoch == want_reg.book_epoch
    assert sorted(got_reg.keys()) == sorted(want_reg.keys())
    for key in want_reg.keys():
        g, w = got_reg.get(key), want_reg.get(key)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        np.testing.assert_array_equal(g.codes, w.codes)
    key = ("grad", "bf16", "hi")
    hists = got_c.histograms("grad", "hi")
    got = per_shard_report(hists, got_reg.get(key).lengths)
    want = ref_stats.per_shard_report(hists, want_reg.get(key).lengths)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k])
    # no code beats Shannon
    assert (got["ideal"] >= got["per_shard_huffman"] - 1e-12).all()
    assert (got["ideal"] >= got["fixed_codebook"] - 1e-12).all()


# ------------------------------------------------------------- encoders
def _words(res):
    return res.words.numpy().view(np.uint32)


@pytest.mark.parametrize("n,skew", [(5000, 0.3), (1, 0.5), (6001, 0.02)])
def test_two_encoders_equal_reference(n, skew):
    """The three-stage baseline: the book, words, bits, stage keys and
    ``wire_bits`` (payload + 8 x 256 bits of book) are the reference's;
    the single stage with that book gives the same words and bits."""
    sym = np.random.default_rng(n).geometric(skew, n).clip(0, 255).astype(
        np.uint8)
    want_res, want_book, want_st = ref_three(sym)
    got_res, got_book, got_st = three_stage_encode(torch.from_numpy(sym),
                                                   device="cpu")
    np.testing.assert_array_equal(got_book.lengths, want_book.lengths)
    np.testing.assert_array_equal(got_book.codes, want_book.codes)
    np.testing.assert_array_equal(_words(got_res),
                                  np.asarray(want_res.words))
    assert int(got_res.n_bits) == int(want_res.n_bits)
    assert got_res.n_symbols == want_res.n_symbols == n
    assert set(got_st) == set(want_st)
    assert got_st["wire_bits"] == want_st["wire_bits"] == int(
        want_res.n_bits) + 8 * 256
    assert all(got_st[k] >= 0 for k in ("freq_scan_s", "tree_build_s",
                                        "encode_s"))
    got1 = single_stage_encode(torch.from_numpy(sym), got_book, device="cpu")
    want1 = ref_single(sym, want_book)
    np.testing.assert_array_equal(_words(got1), _words(got_res))
    np.testing.assert_array_equal(_words(got1), np.asarray(want1.words))
    assert int(got1.n_bits) == int(want1.n_bits) == int(got_res.n_bits)
    assert got1.book_id == want1.book_id
    assert int(encoded_size_bits(np.bincount(sym, minlength=256),
                                 got_book.lengths)) == int(got_res.n_bits)


def test_encoded_size_bits_is_exact_in_int64():
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 1000, 256)
    lengths = rng.integers(1, 16, 256).astype(np.int32)
    got = encoded_size_bits(counts, lengths)
    assert got.dtype == torch.int64
    assert int(got) == int(counts @ lengths) == float(
        ref_size_bits(counts, lengths))
    big = np.full(256, 1 << 22, dtype=np.int64)       # 2^22 x 256 x 15 bits
    assert int(encoded_size_bits(torch.from_numpy(big), np.full(256, 15))) \
        == 15 << 30


def test_encoders_ask_for_the_card():
    """Like every entry point of the port, the two encoders run on CUDA
    unless given ``device="cpu"``, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    sym = np.zeros(16, np.uint8)
    _, book, _ = three_stage_encode(torch.from_numpy(sym), device="cpu")
    for call in (lambda: three_stage_encode(sym),
                 lambda: single_stage_encode(sym, book)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
