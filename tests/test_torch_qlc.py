"""Port parity, QLC codec and the histogram (B5): books, words and
decodes against the JAX reference on the CPU.

QLC books are held equal to the reference's field by field (lengths,
codes, class lengths and bases, ``len_pack`` / ``base_pack``,
``sym_tab``) with the codec-aware content hash; the port's chunked words
equal ``encode_chunked_jit``'s; streams decode across packages in both
directions, and B6's plain walk equals the reference's bit-serial oracle
``decode_chunks_qlc_ref`` (zeros past each count included); B6's kernel
step (a byte permute for the length, a funnel shift for the index) is
spelled out as a numpy walk and held to that oracle at every chunk and
to ``decode_chunks_qlc_pallas`` in interpret mode at chunk 2048.  B5's
plain version is held to ``histogram256_pallas`` in interpret mode, as
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
from repro.kernels.decode import decode_chunks_qlc_pallas  # noqa: E402
from repro.kernels.histogram import histogram256_pallas  # noqa: E402
from repro.kernels.ref import decode_chunks_qlc_ref  # noqa: E402

from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.core.codebook import (build_codebook,  # noqa: E402
                                       registry_content_hash)
from repro_torch.core.codec import (CODECS, default_codec,  # noqa: E402
                                    get_codec, set_default_codec)
from repro_torch.core.encoder import (ChunkedStream,  # noqa: E402
                                      chunk_counts_for, decode_chunked,
                                      encode_chunked, encode_chunked_rows)
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


def _qlc_walk(words, counts, len_pack, base_pack, sym_tab, chunk):
    """Kernel B6's step (walk.cuh's QlcStep) in numpy, every chunk at
    once: the 32 stream bits at the cursor (the word index clamped to
    cap - 2), the class from their top 2 bits, the length as byte `class`
    of len_pack (the byte permute), the index as the window shifted left
    by 2 and right by 34 - l with the shift clamped to 32 (the funnel
    shift: 0 for l = 2), the base 10 bits of base_pack for classes 1..3,
    the symbol sym_tab[min(base + index, 255)]; zeros past each count."""
    w = words.view(np.uint32).astype(np.uint64)
    nb, cap = w.shape
    st = np.zeros(256, np.int64)
    st[:sym_tab.size] = sym_tab
    rows = np.arange(nb)
    pos = np.zeros(nb, np.int64)
    out = np.zeros((nb, chunk), np.int64)
    for k in range(chunk):
        live = k < counts
        widx = np.minimum(pos >> 5, cap - 2)
        pair = (w[rows, widx] << np.uint64(32)) | w[rows, widx + 1]
        win = (pair << (pos & 31).astype(np.uint64)) >> np.uint64(32)
        cls = (win >> np.uint64(30)).astype(np.int64)
        length = (len_pack >> (8 * cls)) & 0xFF
        shifted = (win << np.uint64(2)) & np.uint64(0xFFFFFFFF)
        idx = (shifted >> np.minimum(34 - length, 32).astype(np.uint64)
               ).astype(np.int64)
        base = np.where(cls == 0, 0,
                        (base_pack >> (10 * np.maximum(cls - 1, 0))) & 0x3FF)
        out[:, k] = np.where(live, st[np.minimum(base + idx, 255)], 0)
        pos = np.where(live, pos + length, pos)
    return out


@pytest.mark.parametrize("chunk,n", [(31, 100), (512, 1300), (1001, 1100),
                                     (2048, 2100)])
@pytest.mark.parametrize("kind", ["random", "one_symbol", "uniform256",
                                  "e4m3"])
def test_b6_qlc_step_walk_matches_pallas(kind, chunk, n):
    counts = _counts(kind, 5)
    book = build_qlc_book(counts)
    rng = np.random.default_rng(chunk)
    sym = rng.choice(256, size=n, p=counts / counts.sum()).astype(np.uint8)
    tw, _ = encode_chunked_rows(torch.from_numpy(sym),
                                torch.from_numpy(book.codes.astype(np.int32)),
                                torch.from_numpy(book.lengths.astype(np.int32)),
                                chunk=chunk)
    words = tw.numpy().view(np.uint32)
    cc = chunk_counts_for(n, chunk)
    want = decode_chunks_qlc_ref(words, cc, book.class_lengths,
                                 book.class_bases, book.sym_tab, chunk)
    got = _qlc_walk(tw.numpy(), cc, book.len_pack(), book.base_pack(),
                    book.sym_tab, chunk)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.concatenate([r[:c] for r, c in zip(want, cc)]), sym)
    if chunk == 2048:
        # the Pallas kernel at the logits plane's chunk: one interpret-mode
        # compile for the four books (sym_tab zero-padded to 256, as the
        # kernel pads it); the other chunks hold the walk to the oracle
        st = np.zeros(256, np.int32)
        st[:book.sym_tab.size] = book.sym_tab
        np.testing.assert_array_equal(got, np.asarray(
            decode_chunks_qlc_pallas(jnp.asarray(words), jnp.asarray(cc),
                                     book.len_pack(), book.base_pack(),
                                     jnp.asarray(st), chunk=chunk,
                                     interpret=True)))


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
