"""Port parity, codec core: books, tables, registries, symbol planes and
the plain versions of the four kernels against the JAX reference.

Every table and code is held equal with ``np.array_equal``; the plain
B1/B2 are held to the reference's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), the plain B3/B4 to the reference's
scan walk and multisym Pallas kernel.  B3's kernel step (one lookup in
the book's prefix table, the canonical search where the entry is 0) is
spelled out here as a numpy walk and held to the reference's walk.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import symbols as ref_symbols  # noqa: E402
from repro.core.codebook import (CodebookRegistry as RefRegistry,  # noqa: E402
                                 build_codebook as ref_build,
                                 registry_content_hash as ref_hash)
from repro.core.encoder import (decode_chunks_jit,  # noqa: E402
                                decode_chunks_multisym_jit,
                                encode_chunked_jit, multisym_table_args)
from repro.kernels.bitpack import pack_blocks_pallas  # noqa: E402
from repro.kernels.decode import decode_chunks_multisym_pallas  # noqa: E402
from repro.kernels.encode import encode_lookup_pallas  # noqa: E402

from repro_torch.core import symbols  # noqa: E402
from repro_torch.core.codebook import (CodebookRegistry,  # noqa: E402
                                       build_codebook, registry_content_hash)
from repro_torch.core.encoder import (PREFIX_BITS,  # noqa: E402
                                      canonical_prefix_table,
                                      chunk_counts_for,
                                      decode_chunks_multisym,
                                      encode_chunked_rows)
from repro_torch.kernels.bitpack import pack_blocks  # noqa: E402
from repro_torch.kernels.decode import (decode_chunks_canonical,  # noqa: E402
                                        decode_chunks_multisym as b4)
from repro_torch.kernels.encode import (encode_lookup,  # noqa: E402
                                        encode_lookup_plain)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _counts(seed, skew):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(256, skew))
    counts = rng.multinomial(200_000, p)
    counts[rng.integers(0, 256, 8)] = 0          # unseen symbols get floored
    return counts


def _sym(seed, n, counts):
    rng = np.random.default_rng(seed)
    return rng.choice(256, size=n, p=counts / counts.sum()).astype(np.uint8)


BOOK_CASES = [(0, 0.05), (1, 0.5), (2, 5.0), (3, 0.01)]


@pytest.mark.parametrize("seed,skew", BOOK_CASES)
def test_books_and_tables_equal_reference(seed, skew):
    counts = _counts(seed, skew)
    rb = ref_build(counts, codec="huffman")
    tb = build_codebook(counts, codec="huffman")
    np.testing.assert_array_equal(tb.lengths, rb.lengths)
    np.testing.assert_array_equal(tb.codes, rb.codes)
    np.testing.assert_array_equal(tb.source_counts, rb.source_counts)
    for f in dataclasses.fields(rb.tables):
        np.testing.assert_array_equal(getattr(tb.tables, f.name),
                                      getattr(rb.tables, f.name), f.name)
    rm, tm = rb.multisym_tables(), tb.multisym_tables()
    for f in dataclasses.fields(rm):
        np.testing.assert_array_equal(getattr(tm, f.name),
                                      getattr(rm, f.name), f.name)
    np.testing.assert_array_equal(tb.code_lut(), rb.code_lut())


def _registries():
    ref = RefRegistry(codec="huffman")
    port = CodebookRegistry(codec="huffman")
    for i, plane in enumerate(("lo", "hi")):
        counts = _counts(10 + i, 0.1)
        ref.install(("act", "bf16", plane), counts)
        port.install(("act", "bf16", plane), counts)
    return ref, port


def test_registry_hash_and_cross_package_load(tmp_path):
    ref, port = _registries()
    assert (registry_content_hash(port.snapshot().books)
            == ref_hash(ref.snapshot().books)
            == port.snapshot().content_hash)
    ref.save(str(tmp_path / "ref.npz"))
    port.save(str(tmp_path / "port.npz"))
    from_ref = CodebookRegistry.load(str(tmp_path / "ref.npz"))
    from_port = RefRegistry.load(str(tmp_path / "port.npz"))
    assert from_ref.snapshot().content_hash == ref.snapshot().content_hash
    assert from_port.snapshot().content_hash == port.snapshot().content_hash
    assert from_ref.book_epoch == ref.book_epoch
    for key in ref.keys():
        np.testing.assert_array_equal(from_ref.get(key).lengths,
                                      ref.get(key).lengths)


def test_symbol_planes_equal_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    want = ref_symbols.bf16_planes_np(x)
    got = symbols.bf16_planes(torch.from_numpy(x))
    for plane in ("lo", "hi"):
        np.testing.assert_array_equal(got[plane].numpy(), want[plane])
    e = np.clip(x, -440, 440)
    want = ref_symbols.SCHEMES["e4m3"].to_symbols(e)["b0"]
    got = symbols.e4m3_planes(torch.from_numpy(e))["b0"]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2048, 5000])
def test_plain_b1_matches_encode_lookup_pallas(n):
    counts = _counts(n, 0.05)
    book = build_codebook(counts, codec="huffman")
    sym = _sym(n, n, counts)
    rc, rl, rbits = encode_lookup_pallas(jnp.asarray(sym),
                                         jnp.asarray(book.code_lut()),
                                         interpret=True)
    (lut,) = book.device_tables("lut", CPU)
    for given in (sym, sym.astype(np.int32)):          # uint8 and int32
        tc, tl, tbits = encode_lookup(torch.from_numpy(given), lut)
        # codes and lengths: the contiguous int32 rows of one (2, N) tensor
        for t in (tc, tl):
            assert t.dtype == torch.int32 and t.shape == (n,)
            assert t.is_contiguous()
        assert tbits.dtype == torch.int64 and tbits.shape == ()
        np.testing.assert_array_equal(tc.numpy().view(np.uint32),
                                      np.asarray(rc))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(rl))
        assert int(tbits) == int(rbits) == int(book.lengths[sym].sum())
        for a, b in zip(encode_lookup_plain(torch.from_numpy(given), lut),
                        (tc, tl, tbits)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [100, 2048, 2049, 6000])
def test_plain_b2_matches_pack_blocks_pallas(n):
    counts = _counts(n, 0.05)
    book = build_codebook(counts, codec="huffman")
    sym = _sym(n + 1, n, counts)
    idx = torch.from_numpy(sym.astype(np.int64))
    codes = torch.from_numpy(book.codes.astype(np.int32))[idx]
    lens = torch.from_numpy(book.lengths.astype(np.int32))[idx]
    rw, rb = pack_blocks_pallas(jnp.asarray(codes.numpy()),
                                jnp.asarray(lens.numpy()), interpret=True)
    tw, tbits = pack_blocks(codes, lens, chunk=2048)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(rw))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(rb))


def _stream(book, sym, chunk):
    w, b = encode_chunked_jit(jnp.asarray(sym), jnp.asarray(book.codes),
                              jnp.asarray(book.lengths), chunk=chunk)
    counts = chunk_counts_for(sym.shape[0], chunk)
    return (w, jnp.asarray(counts),
            torch.from_numpy(np.array(w).view(np.int32)),
            torch.from_numpy(counts))


@pytest.mark.parametrize("chunk,n", [(31, 100), (1001, 1100), (2048, 2100)])
def test_plain_b3_b4_match_reference_decoders(chunk, n):
    counts = _counts(chunk, 0.02)
    book = build_codebook(counts, codec="huffman")
    sym = _sym(chunk + 7, n, counts)
    rw, rc, tw, tc = _stream(book, sym, chunk)
    t = book.tables
    targs = [jnp.asarray(a) for a in (t.first_code, t.base_index,
                                      t.num_codes, t.sorted_symbols)]
    want = np.asarray(decode_chunks_jit(rw, rc, *targs, chunk=chunk))
    canon = book.device_tables("canonical", CPU)
    got = decode_chunks_canonical(tw, tc, *canon, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)

    want_b4 = np.asarray(decode_chunks_multisym_pallas(
        rw, rc, *multisym_table_args(book, full=False), *targs, chunk=chunk,
        interpret=True))
    got_b4 = b4(tw, tc, *book.device_tables("multisym", CPU), *canon,
                chunk=chunk)
    np.testing.assert_array_equal(got_b4.numpy(), want_b4)
    np.testing.assert_array_equal(want_b4, want)

    want_ms = np.asarray(decode_chunks_multisym_jit(
        rw, rc, *multisym_table_args(book), chunk=chunk))
    got_ms = decode_chunks_multisym(tw, tc,
                                    *book.device_tables("multisym", CPU),
                                    *canon, chunk=chunk)
    np.testing.assert_array_equal(got_ms.numpy(), want_ms)


def test_plain_b4_slow_path_long_codes():
    # A steep geometric histogram forces codes of 14..16 bits, so the
    # K=13 LUT's slow path runs on a large share of the symbols.
    counts = np.maximum((2.0 ** -np.arange(256) * 2 ** 40).astype(np.int64), 1)
    book = build_codebook(counts, codec="huffman")
    assert book.lengths.max() == 16
    rng = np.random.default_rng(9)
    sym = rng.integers(0, 256, 1500).astype(np.uint8)   # mostly long codes
    rw, rc, tw, tc = _stream(book, sym, 1001)
    got = b4(tw, tc, *book.device_tables("multisym", CPU),
             *book.device_tables("canonical", CPU), chunk=1001)
    np.testing.assert_array_equal(got.numpy()[0], sym[:1001])
    np.testing.assert_array_equal(got.numpy()[1, :499], sym[1001:])
    assert not got.numpy()[1, 499:].any()


def _prefix_walk(words, counts, tables, prefix, chunk, max_len):
    """Kernel B3's walk in numpy, every chunk at once: per step the 32
    stream bits at the cursor (the word index clamped to cap - 2, as the
    kernel's reader does), one lookup of their top PREFIX_BITS bits in the
    prefix table (``symbol | length << 8``), and, where the entry is 0,
    the canonical search from length PREFIX_BITS + 1 (no shorter code
    starts such a window; with no valid length it falls back to length 1)
    with sorted_symbols padded to 256 by its last entry, as the kernel
    holds it."""
    w = words.view(np.uint32).astype(np.uint64)
    nb, cap = w.shape
    fc, bi, nc, ss = (np.asarray(t, np.int64) for t in tables)
    ss = ss[np.minimum(np.arange(256), ss.size - 1)]
    pre = np.asarray(prefix, np.int64) & 0xFFFF
    rows = np.arange(nb)
    pos = np.zeros(nb, np.int64)
    out = np.zeros((nb, chunk), np.int64)
    for k in range(chunk):
        live = k < counts
        widx = np.minimum(pos >> 5, cap - 2)
        pair = (w[rows, widx] << np.uint64(32)) | w[rows, widx + 1]
        win = ((pair << (pos & 31).astype(np.uint64)) >> np.uint64(32)
               ).astype(np.int64)
        e = pre[win >> (32 - PREFIX_BITS)]
        length, sym = e >> 8, e & 0xFF
        slow = np.nonzero(length == 0)[0]
        if slow.size:                      # codes over PREFIX_BITS bits
            top = win[slow] >> (32 - max_len)
            found = np.zeros(slow.size, bool)
            sl = np.ones(slow.size, np.int64)          # the search's fallback
            off = (top >> (max_len - 1)) - fc[1]
            for ln in range(PREFIX_BITS + 1, max_len + 1):   # none shorter
                o = (top >> (max_len - ln)) - fc[ln]
                hit = ~found & (o >= 0) & (o < nc[ln])
                sl, off = np.where(hit, ln, sl), np.where(hit, o, off)
                found |= hit
            length[slow] = sl
            sym[slow] = ss[np.clip(bi[sl] + off, 0, 255)]
        out[:, k] = np.where(live, sym, 0)
        pos = np.where(live, pos + length, pos)
    return out


def _b3_books():
    """A steep geometric book (codes up to 16 bits, most over
    PREFIX_BITS), a book of max_len 10 (every prefix entry decided) and a
    one-symbol book, each with the symbols it codes."""
    rng = np.random.default_rng(21)
    steep = np.maximum((2.0 ** -np.arange(256) * 2 ** 40).astype(np.int64), 1)
    head = np.minimum(rng.geometric(0.4, 3000) - 1, 255)
    mixed = np.where(rng.random(3000) < 0.5, head,
                     rng.integers(0, 256, 3000)).astype(np.uint8)
    short_counts = _counts(22, 0.3)
    one = np.zeros(256, np.int64)
    one[7] = 100
    return {"steep": (build_codebook(steep), mixed),
            "short": (build_codebook(short_counts, max_len=10),
                      _sym(23, 3000, short_counts)),
            "one_symbol": (build_codebook(one, floor=0),
                           np.full(3000, 7, np.uint8))}


@pytest.mark.parametrize("chunk,n", [(31, 100), (1001, 1100), (2048, 2100)])
@pytest.mark.parametrize("name", ["steep", "short", "one_symbol"])
def test_b3_prefix_step_walk_matches_reference(name, chunk, n):
    book, sym = _b3_books()[name]
    sym = sym[:n]
    max_len = book.max_len
    if name == "steep":
        assert book.lengths.max() == 16 > PREFIX_BITS
        assert (book.lengths[sym] > PREFIX_BITS).any()  # the search runs
    if name == "short":
        assert max_len <= PREFIX_BITS
    tw, _ = encode_chunked_rows(torch.from_numpy(sym),
                                torch.from_numpy(book.codes),
                                torch.from_numpy(book.lengths), chunk=chunk,
                                max_len=max_len)
    counts = chunk_counts_for(n, chunk)
    t = book.tables
    want = np.asarray(decode_chunks_jit(
        jnp.asarray(tw.numpy().view(np.uint32)), jnp.asarray(counts),
        *(jnp.asarray(a) for a in (t.first_code, t.base_index, t.num_codes,
                                   t.sorted_symbols)),
        chunk=chunk, max_len=max_len))
    canon = book.device_tables("canonical", CPU)
    (prefix,) = book.device_tables("prefix", CPU)
    assert torch.equal(prefix, canonical_prefix_table(canon, max_len))
    got = _prefix_walk(tw.numpy(), counts, canon, prefix.numpy(), chunk,
                       max_len)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.concatenate([r[:c] for r, c in zip(want, counts)]), sym)
    # the wrapper, with the book's prefix table and without one
    tc = torch.from_numpy(counts)
    for kw in ({"prefix": prefix}, {}):
        got_w = decode_chunks_canonical(tw, tc, *canon, chunk=chunk,
                                        max_len=max_len, **kw)
        np.testing.assert_array_equal(got_w.numpy(), want)
