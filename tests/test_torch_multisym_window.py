"""Port parity, B4 over the reference's window domain: any K in 1..16 and
any s_max, the LUTs that ``decode_chunks_multisym_pallas`` decodes.

The port's ``build_multisym_tables`` is held equal to the reference's,
its plain B4 (the kernel's CPU version) to the stream it decodes at each
(K, s_max) and to the reference's Pallas kernel in interpret mode at two
windows that are not the default, and the wrapper's row class and
re-striding (``multisym_rows``: rows of 8 or 16 bytes, a copy only
where s_max is neither) to their byte counts.
"""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.huffman import (build_multisym_tables  # noqa: E402
                                as ref_build_multisym)
from repro.kernels.decode import decode_chunks_multisym_pallas  # noqa: E402

from repro_torch.core.codebook import (build_codebook,  # noqa: E402
                                       multisym_device_tables)
from repro_torch.core.encoder import (chunk_counts_for,  # noqa: E402
                                      encode_chunked_rows)
from repro_torch.kernels.decode import (  # noqa: E402
    decode_chunks_multisym, decode_chunks_multisym_plain,
    multisym_row_bytes, multisym_rows)

torch.set_num_threads(1)

KS = (1, 2, 7, 12, 14, 16)
SMAX = (1, 3, 8, 16, 24)
CHUNK = 512


@functools.lru_cache(maxsize=None)
def _book_and_stream():
    """A max_len-16 book with codes of 1 to 16 bits and a seeded stream
    of 3000 symbols drawn from its counts (short codes mostly, some past
    K = 14 so that the search runs)."""
    rng = np.random.default_rng(28)
    counts = np.maximum((2.0 ** -np.arange(256) * 2 ** 40).astype(np.int64),
                        1)
    book = build_codebook(counts)
    head = np.minimum(rng.geometric(0.35, 3000) - 1, 255)
    sym = np.where(rng.random(3000) < 0.7, head,
                   rng.integers(0, 256, 3000)).astype(np.uint8)
    words, _ = encode_chunked_rows(torch.from_numpy(sym),
                                   torch.from_numpy(book.codes),
                                   torch.from_numpy(book.lengths),
                                   chunk=CHUNK, max_len=book.max_len)
    return book, sym, words, chunk_counts_for(sym.size, CHUNK)


@pytest.mark.parametrize("s_max", SMAX)
@pytest.mark.parametrize("k", KS)
def test_multisym_tables_equal_reference(k, s_max):
    book, *_ = _book_and_stream()
    assert book.max_len == 16 and book.lengths.max() == 16
    got = book.multisym_tables(k=k, s_max=s_max)
    want = ref_build_multisym(book.lengths, k=k, s_max=s_max,
                              max_len=book.max_len)
    for name in ("syms", "meta", "meta_full", "sym_full", "step_tab",
                 "emit_tab"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    # a window holds at most min(s_max, K) codes: the columns past it are 0
    assert ((got.meta & 0xFF) <= min(s_max, k)).all()
    assert not got.syms[:, min(s_max, k):].any()


@pytest.mark.parametrize("s_max", SMAX)
@pytest.mark.parametrize("k", KS)
def test_plain_b4_round_trips_every_window(k, s_max):
    book, sym, words, counts = _book_and_stream()
    lut = multisym_device_tables(book.multisym_tables(k=k, s_max=s_max),
                                 "cpu")
    canon = book.device_tables("canonical", "cpu")
    if k < book.max_len:
        assert (book.lengths[sym] > k).any()        # the search runs
    out = decode_chunks_multisym(words, torch.from_numpy(counts), *lut,
                                 *canon, chunk=CHUNK, max_len=book.max_len)
    got = np.concatenate([r[:c] for r, c in zip(out.numpy(), counts)])
    np.testing.assert_array_equal(got, sym)
    assert not any(r[c:].any() for r, c in zip(out.numpy(), counts))


@pytest.mark.parametrize("k,s_max", [(9, 3), (16, 16)])
def test_plain_b4_equals_reference_kernel(k, s_max):
    """One interpret-mode compile a window."""
    book, sym, words, counts = _book_and_stream()
    mt = book.multisym_tables(k=k, s_max=s_max)
    t = book.tables
    ss = np.zeros(256, np.int32)
    ss[:t.sorted_symbols.size] = t.sorted_symbols
    want = np.asarray(decode_chunks_multisym_pallas(
        jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(counts),
        jnp.asarray(mt.syms), jnp.asarray(mt.meta),
        *(jnp.asarray(x) for x in (t.first_code, t.base_index, t.num_codes,
                                   ss)),
        chunk=CHUNK, max_len=book.max_len, interpret=True))
    got = decode_chunks_multisym_plain(
        words, torch.from_numpy(counts),
        *multisym_device_tables(mt, "cpu"),
        *book.device_tables("canonical", "cpu"), chunk=CHUNK,
        max_len=book.max_len)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s_max", SMAX + (13,))
@pytest.mark.parametrize("k", KS + (9, 13))
def test_rows_by_window(k, s_max):
    """R = 8 bytes where W = min(s_max, K) <= 8, else 16; the LUT itself
    where s_max is R, else a copy of 2^K * R bytes holding its first W
    columns.  At 2^K rows the LUT takes meta 2^K * 2 bytes and rows 2^K *
    R: 16 KB + 64 KB at K = 13, R = 8, the default; 128 KB + 1 MB at K =
    16, R = 16."""
    syms = torch.from_numpy(np.random.default_rng(k * 31 + s_max).integers(
        0, 256, (1 << k, s_max), dtype=np.uint8))
    w = min(s_max, k)
    syms[:, w:] = 0                    # as build_multisym_tables does
    rows, row = multisym_rows(syms)
    assert row == multisym_row_bytes(1 << k, s_max) == (8 if w <= 8 else 16)
    assert tuple(rows.shape) == (1 << k, row) and rows.is_contiguous()
    assert (rows.data_ptr() == syms.data_ptr()) == (s_max == row)
    assert torch.equal(rows[:, :w], syms[:, :w]) and not rows[:, w:].any()
    assert rows.numel() == (1 << k) * row
    if (k, s_max) == (13, 8):
        assert (rows.numel(), 2 << k) == (65536, 16384)
    if (k, s_max) == (16, 16):
        assert (rows.numel(), 2 << k) == (1 << 20, 131072)
