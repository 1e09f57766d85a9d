"""Port parity, codec core: books, tables, registries, symbol planes and
the plain versions of the four kernels against the JAX reference.

Every table and code is held equal with ``np.array_equal``; the plain
B1/B2 are held to the reference's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), the plain B3/B4 to the reference's
scan walk and multisym Pallas kernel.  B3's kernel step (one lookup in
the book's prefix table, the canonical search where the entry is 0) and
B4's (one K-bit meta lookup, the search beside it, staging and slices
cut by symbols) are spelled out here as numpy walks: B3's held to the
reference's walk, B4's to its bit-serial ``decode_np`` at every chunk
and its multisym Pallas kernel in interpret mode at chunk 2048.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import symbols as ref_symbols  # noqa: E402
from repro.core.codebook import (CodebookRegistry as RefRegistry,  # noqa: E402
                                 build_codebook as ref_build,
                                 registry_content_hash as ref_hash)
from repro.core.encoder import (decode_chunks_jit,  # noqa: E402
                                decode_chunks_multisym_jit, decode_np,
                                encode_chunked_jit, multisym_table_args)
from repro.kernels.bitpack import pack_blocks_pallas  # noqa: E402
from repro.kernels.decode import decode_chunks_multisym_pallas  # noqa: E402
from repro.kernels.encode import encode_lookup_pallas  # noqa: E402

from repro_torch.core import symbols  # noqa: E402
from repro_torch.core.codebook import (CodebookRegistry,  # noqa: E402
                                       build_codebook, registry_content_hash)
from repro_torch.core.huffman import (MULTISYM_K,  # noqa: E402
                                      MULTISYM_SMAX)
from repro_torch.core.encoder import (PREFIX_BITS,  # noqa: E402
                                      canonical_prefix_table,
                                      chunk_counts_for,
                                      decode_chunks_multisym,
                                      encode_chunked_rows)
from repro_torch.kernels.bitpack import pack_blocks  # noqa: E402
from repro_torch.kernels.decode import (decode_chunks_canonical,  # noqa: E402
                                        decode_chunks_multisym as b4,
                                        multisym_rows)
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


def _window(w, pos, cap):
    """The 32 stream bits at each chunk's cursor, the word index clamped
    to cap - 2 as the kernels' reader clamps it."""
    rows = np.arange(w.shape[0])
    widx = np.minimum(pos >> 5, cap - 2)
    pair = (w[rows, widx] << np.uint64(32)) | w[rows, widx + 1]
    return ((pair << (pos & 31).astype(np.uint64)) >> np.uint64(32)
            ).astype(np.int64)


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
    pos = np.zeros(nb, np.int64)
    out = np.zeros((nb, chunk), np.int64)
    for k in range(chunk):
        live = k < counts
        win = _window(w, pos, cap)
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


@functools.lru_cache(maxsize=None)
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


SLICE = 64          # the symbols of a staged slice (walk.cuh's kSlice)


def _multisym_walk(words, counts, syms, meta, tables, chunk, max_len):
    """Kernel B4's walk in numpy, every chunk at once.  The wrapper hands
    the kernel rows of R = 8 or 16 bytes (``multisym_rows``: W = min(s_max,
    K) symbols, zero past them).  A step looks up the window's top K bits
    in meta (``count | bits << 8``); beside it the canonical search runs
    over lengths K+1..max_len, falling back to length K + 1 (the
    reference's argmax over an all-false vector) with sorted_symbols
    padded to 256 by its last entry, and a count of 0 takes the search's
    length and one symbol (with K >= max_len there is no search: length
    0, symbol 0).  A step stages its row's R bytes at the chunk's row
    byte q, the rest of the last word they touch zeroed, as the kernel's
    R / 4 + 1 word stores leave it.  Slices are cut by symbols: a chunk
    walks until it has decoded k0 + SLICE symbols or its count; then
    positions past the count are zeroed, the slice is written out from
    byte r (the row's misalignment), and the bytes past it (up to R - 1
    symbols and the word that holds the next byte) move to the row's
    front for the next slice."""
    w = words.view(np.uint32).astype(np.uint64)
    nb, cap = w.shape
    size = syms.shape[0]
    k = size.bit_length() - 1
    rows_t, s = multisym_rows(torch.as_tensor(np.asarray(syms, np.uint8)))
    words_a_row = s // 4 + 1            # a window's word stores
    row_bytes = 4 * ((3 + SLICE - 1) // 4 + words_a_row)
    carry = 4 * ((3 + s - 1) // 4 + 1)
    fc, bi, nc, ss = (np.asarray(t, np.int64) for t in tables)
    ss = ss[np.minimum(np.arange(256), ss.size - 1)]
    meta = np.asarray(meta, np.int64) & 0xFFFF
    syms = rows_t.numpy()
    rows = np.zeros((nb, row_bytes), np.uint8)
    r = (np.arange(nb) * chunk) & 3
    pos = np.zeros(nb, np.int64)         # the cursor's bit
    done = np.zeros(nb, np.int64)        # symbols decoded
    out = np.zeros((nb, chunk), np.int64)
    for k0 in range(0, chunk, SLICE):
        k1 = min(k0 + SLICE, chunk)
        end = np.minimum(k0 + SLICE, counts)
        q = r + done - k0
        while True:
            live = np.nonzero(done < end)[0]
            if not live.size:
                break
            win = _window(w[live], pos[live], cap)
            m = meta[win >> (32 - k)]
            cnt, adv = m & 0xFF, m >> 8
            row = syms[win >> (32 - k)].astype(np.int64)      # (live, s)
            slow = cnt == 0
            if k < max_len:
                top = win >> (32 - max_len)
                sl = np.full(live.size, k + 1)
                off = (top >> (max_len - k - 1)) - fc[k + 1]
                found = np.zeros(live.size, bool)
                for ln in range(k + 1, max_len + 1):
                    o = (top >> (max_len - ln)) - fc[ln]
                    hit = ~found & (o >= 0) & (o < nc[ln])
                    sl, off = np.where(hit, ln, sl), np.where(hit, o, off)
                    found |= hit
                ssym = ss[np.clip(bi[sl] + off, 0, 255)]
            else:
                sl, ssym = np.zeros(live.size, np.int64), 0
            row = np.where(slow[:, None], 0, row)
            row[:, 0] = np.where(slow, ssym, row[:, 0])
            ql = q[live]
            for j in range(s):
                rows[live, ql + j] = row[:, j]
            for j in range(s, s + 4):            # the last word's rest
                tail = (ql + j) < ((ql >> 2) + words_a_row) * 4
                rows[live[tail], (ql + j)[tail]] = 0
            n = np.where(slow, 1, cnt)
            pos[live] += np.where(slow, sl, adv)
            q[live] += n
            done[live] += n
        for c in range(nb):
            rows[c, r[c] + max(counts[c], k0) - k0:r[c] + k1 - k0] = 0
            out[c, k0:k1] = rows[c, r[c]:r[c] + k1 - k0]
        rows[:, :carry] = rows[:, SLICE:SLICE + carry]
    return out


@functools.lru_cache(maxsize=None)
def _b4_books():
    """B3's steep and one-symbol books (max_len 16: at K = 13 the search
    over lengths 14-16 runs beside the lookup) and the steep counts
    limited to max_len 13 = MULTISYM_K (the kernel's walk with no search
    at K = 13), and a skewed book (one 1-bit code, two 2-bit codes)
    whose stream nearly fills every window: at K = 16 a window of up to
    16 symbols, cut off the slices' grid by the 2-bit codes, runs up to
    15 symbols past a slice."""
    books = _b3_books()
    steep = np.maximum((2.0 ** -np.arange(256) * 2 ** 40).astype(np.int64), 1)
    skew = np.zeros(256, np.int64)
    skew[[7, 3, 200]] = 1 << 20, 1, 1
    rng = np.random.default_rng(28)
    skewed = np.where(rng.random(3000) < 0.95, 7,
                      np.where(rng.random(3000) < 0.5, 3, 200))
    return {"steep": books["steep"], "one_symbol": books["one_symbol"],
            "len13": (build_codebook(steep, max_len=MULTISYM_K),
                      books["steep"][1]),
            "skewed": (build_codebook(skew, floor=0),
                       skewed.astype(np.uint8))}


def _oracle_rows(words, counts, book, chunk):
    """Each chunk decoded by the reference's bit-serial ``decode_np``,
    zeros past its count."""
    out = np.zeros((words.shape[0], chunk), np.int64)
    for i, (row, c) in enumerate(zip(words.view(np.uint32), counts)):
        out[i, :c] = decode_np(row, int(c), book)
    return out


@pytest.mark.parametrize("window", ["13x8", "12x16", "max_len x16"])
@pytest.mark.parametrize("chunk,n", [(31, 100), (512, 1300), (1001, 1100),
                                     (1001, 3000), (2048, 2100)])
@pytest.mark.parametrize("name", ["steep", "len13", "one_symbol", "skewed"])
def test_b4_multisym_step_walk_matches_reference(name, chunk, n, window):
    """At the default LUT (K = 13, s_max = 8: rows of 8 bytes), at K = 12
    with s_max = 16 (rows of 16, W = 12) and at K = the book's max_len
    with s_max = 16 (no search; rows of 16)."""
    book, sym = _b4_books()[name]
    sym = sym[:n]
    max_len = book.max_len
    k, s_max = {"13x8": (MULTISYM_K, MULTISYM_SMAX), "12x16": (12, 16),
                "max_len x16": (max_len, 16)}[window]
    mt = book.multisym_tables(k=k, s_max=s_max)
    assert mt.syms.shape == (1 << k, s_max)
    if name == "steep" and k < max_len:
        assert (book.lengths[sym] > k).any()    # the search runs
    if name == "len13":
        assert max_len == book.lengths.max() == MULTISYM_K
    tw, _ = encode_chunked_rows(torch.from_numpy(sym),
                                torch.from_numpy(book.codes),
                                torch.from_numpy(book.lengths), chunk=chunk,
                                max_len=max_len)
    counts = chunk_counts_for(n, chunk)
    want = _oracle_rows(tw.numpy(), counts, book, chunk)
    got = _multisym_walk(tw.numpy(), counts, mt.syms, mt.meta,
                         book.device_tables("canonical", CPU), chunk, max_len)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.concatenate([r[:c] for r, c in zip(want, counts)]), sym)
    if chunk == 2048 and window == "13x8":
        # the Pallas kernel at the logits plane's chunk and the default
        # LUT: one interpret-mode compile a max_len (sorted_symbols
        # zero-padded to 256, as the kernel pads it); the other chunks and
        # windows hold the walk to the oracle
        t = book.tables
        ss = np.zeros(256, np.int32)
        ss[:t.sorted_symbols.size] = t.sorted_symbols
        np.testing.assert_array_equal(got, np.asarray(
            decode_chunks_multisym_pallas(
                jnp.asarray(tw.numpy().view(np.uint32)), jnp.asarray(counts),
                jnp.asarray(mt.syms), jnp.asarray(mt.meta),
                *(jnp.asarray(x) for x in (t.first_code, t.base_index,
                                           t.num_codes, ss)),
                chunk=chunk, max_len=max_len, interpret=True)))
