"""Port parity, QLC codec and the histogram (B5): books, words and
decodes against the JAX reference on the CPU.

QLC books are held equal to the reference's field by field (lengths,
codes, class lengths and bases, ``len_pack`` / ``base_pack``,
``sym_tab``) with the codec-aware content hash; the port's chunked words
equal ``encode_chunked_jit``'s; streams decode across packages in both
directions, and B6's plain walk equals the reference's bit-serial oracle
``decode_chunks_qlc_ref`` (zeros past each count included).  B5's plain
version is held to ``histogram256_pallas`` in interpret mode, as
``tests/test_kernels.py`` runs it.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.codebook import registry_content_hash as ref_hash  # noqa: E402
from repro.core.encoder import (ChunkedStream as RefStream,  # noqa: E402
                                decode_chunked as ref_decode_chunked,
                                encode_chunked_jit)
from repro.core.qlc import build_qlc_book as ref_build_qlc  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.histogram import histogram256_pallas  # noqa: E402
from repro.kernels.ref import decode_chunks_qlc_ref  # noqa: E402

from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.core.codebook import (build_codebook,  # noqa: E402
                                       registry_content_hash)
from repro_torch.core.codec import (CODECS, default_codec,  # noqa: E402
                                    get_codec, set_default_codec)
from repro_torch.core.encoder import (ChunkedStream,  # noqa: E402
                                      decode_chunked, encode_chunked)
from repro_torch.core.qlc import (build_qlc_book,  # noqa: E402
                                  qlc_book_from_lengths, qlc_kernel_args)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode import decode_chunks_qlc  # noqa: E402
from repro_torch.kernels.histogram import (histogram256,  # noqa: E402
                                           histogram256_plain)

torch.set_num_threads(1)


def _e4m3_bytes(rng, n):
    """e4m3-quantized gaussian activations viewed as bytes."""
    x = torch.from_numpy(rng.normal(0.0, 1.0, n).astype(np.float32))
    return x.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def _counts(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.maximum(rng.integers(0, 10000, 256) ** 2, 1)
    if kind == "one_symbol":
        c = np.ones(256, np.int64)
        c[int(rng.integers(0, 256))] = 10 ** 9
        return c
    if kind == "uniform256":
        return np.full(256, 1000, np.int64)
    return np.bincount(_e4m3_bytes(rng, 1 << 16), minlength=256)


@pytest.mark.parametrize("kind", ["random", "one_symbol", "uniform256",
                                  "e4m3"])
def test_qlc_books_equal_reference(kind):
    counts = _counts(kind, 5)
    rb = ref_build_qlc(counts, key=("act", "e4m3", "b0"))
    tb = build_qlc_book(counts, key=("act", "e4m3", "b0"))
    for f in ("lengths", "codes", "sym_tab", "source_counts"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(rb, f), f)
    assert tb.class_lengths == rb.class_lengths
    assert tb.class_bases == rb.class_bases
    assert (tb.len_pack(), tb.base_pack()) == (rb.len_pack(), rb.base_pack())
    assert registry_content_hash([tb]) == ref_hash([rb])
    # the codec identity is part of the hash: same lengths, other codec
    assert registry_content_hash([tb]) != registry_content_hash(
        [build_codebook(counts, codec="huffman")])
    again = qlc_book_from_lengths(tb.lengths)
    np.testing.assert_array_equal(again.codes, tb.codes)
    if kind == "uniform256":
        assert tb.class_lengths == (8, 8, 8, 8)
    if kind == "one_symbol":
        assert int(tb.lengths.min()) == 2


@pytest.mark.parametrize("chunk", [31, 1001, 2048])
def test_qlc_words_equal_reference_and_decode_across_packages(chunk):
    rng = np.random.default_rng(chunk)
    sym = _e4m3_bytes(rng, 3 * chunk + 7)           # a ragged tail chunk
    counts = np.bincount(sym[::2], minlength=256)
    rb, tb = ref_build_qlc(counts), build_codebook(counts, codec="qlc")
    rw, rbits = encode_chunked_jit(jnp.asarray(sym), jnp.asarray(rb.codes),
                                   jnp.asarray(rb.lengths), chunk=chunk)
    st = encode_chunked(sym, tb, chunk=chunk, device="cpu")
    np.testing.assert_array_equal(st.block_words.numpy().view(np.uint32),
                                  np.asarray(rw))
    np.testing.assert_array_equal(st.block_bits.numpy(), np.asarray(rbits))

    # B6's plain walk equals the bit-serial oracle, zeros past each count
    counts_t = torch.from_numpy(st.chunk_counts())
    got = decode_chunks_qlc(st.block_words, counts_t,
                            *qlc_kernel_args(tb, "cpu"), chunk=chunk)
    want = decode_chunks_qlc_ref(np.asarray(rw), st.chunk_counts(),
                                 rb.class_lengths, rb.class_bases,
                                 np.asarray(rb.sym_tab), chunk)
    np.testing.assert_array_equal(got.numpy(), want)

    # reference-encoded → port-decoded, both backend names
    rst = ChunkedStream(torch.from_numpy(np.array(rw).view(np.int32)),
                        torch.from_numpy(np.array(rbits)), sym.shape[0],
                        chunk)
    for backend in ("scan", "pallas"):
        np.testing.assert_array_equal(
            decode_chunked(rst, tb, backend=backend).numpy(), sym, backend)
    # port-encoded → reference-decoded (scan; the Pallas kernel in
    # interpret mode at the smallest chunk)
    rs = RefStream(jnp.asarray(st.block_words.numpy().view(np.uint32)),
                   jnp.asarray(st.block_bits.numpy()), sym.shape[0], chunk)
    backends = ("scan", "pallas") if chunk == 31 else ("scan",)
    for backend in backends:
        np.testing.assert_array_equal(
            np.asarray(ref_decode_chunked(rs, rb, backend=backend)), sym)


@pytest.mark.parametrize("n", [1, 4095, 4097, 10_001])
def test_histogram_plain_equals_pallas(n):
    rng = np.random.default_rng(n)
    sym = np.minimum(rng.geometric(0.05, n), 255).astype(np.uint8)
    want = np.asarray(histogram256_pallas(jnp.asarray(sym)))
    for t in (torch.from_numpy(sym), torch.from_numpy(sym.astype(np.int32))):
        np.testing.assert_array_equal(histogram256(t).numpy(), want)
        assert histogram256(t).dtype == torch.int64
    np.testing.assert_array_equal(
        histogram256_plain(torch.from_numpy(sym).reshape(-1, 1)).numpy(), want)
    lengths = build_codebook(np.bincount(sym, minlength=256)).lengths
    assert int(ops.message_bits(torch.from_numpy(sym), lengths)) == int(
        ref_ops.message_bits(jnp.asarray(sym), jnp.asarray(lengths)))


def test_qlc_codec_registry():
    assert sorted(CODECS) == ["huffman", "qlc"]
    codec = get_codec("qlc")
    assert codec.backends == ("scan", "pallas")
    assert codec.resolve_backend("auto") == "scan"
    with pytest.raises(ValueError):
        codec.resolve_backend("multisym")
    counts = _counts("random", 1)
    assert build_codebook(counts, codec="qlc").codec_name == "qlc"
    spec = CompressionSpec.from_books(
        {"lo": build_qlc_book(counts), "hi": build_qlc_book(counts)},
        "bf16", mode="bitexact")
    assert (spec.codec, spec.decode_backend) == ("qlc", "scan")
    prev = set_default_codec("qlc")
    try:
        assert default_codec() == "qlc"
        assert build_codebook(counts).codec_name == "qlc"
        assert CompressionSpec().codec == "qlc"
    finally:
        assert set_default_codec(prev) == "qlc"
    assert default_codec() == "huffman"
    with pytest.raises(ValueError):
        set_default_codec("nope")
