"""Port parity, codec core: books, tables, registries, symbol planes and
the plain versions of the four kernels against the JAX reference.

Every table and code is held equal with ``np.array_equal``; the plain
B1/B2 are held to the reference's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), the plain B3/B4 to the reference's
scan walk and multisym Pallas kernel.
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
from repro_torch.core.encoder import (chunk_counts_for,  # noqa: E402
                                      decode_chunks_multisym)
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
    tc, tl, tbits = encode_lookup(torch.from_numpy(sym), lut)
    np.testing.assert_array_equal(tc.numpy().view(np.uint32), np.asarray(rc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(rl))
    assert int(tbits) == int(rbits)
    for a, b in zip(encode_lookup_plain(torch.from_numpy(sym), lut),
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
