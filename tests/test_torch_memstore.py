"""Port parity, compressed-at-rest serving: the coded param store, the
fused decode + matmul (B7/B8's plain versions), the coded KV cache, the
coded-serve engine and compressed checkpoints, against the JAX
reference on the small ``memck`` model of ``launch/dryrun.py
--memstore-check``, under both codecs, on the CPU.

Weights are drawn with numpy into the reference's tree and reach the
port through ``models.convert.from_jax_params``, so both packages code
the same bytes: tight words, bit counts and footprints are held equal with
``np.array_equal``; decoded weights, tiles, caches and logits bit for
bit; the fused product at float32 tolerance (rtol 1e-6, atol 1e-7:
the two sum the same exact products in different orders).
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import (load_compressed_store as ref_load,  # noqa: E402
                              save_compressed as ref_save)
from repro.kernels.ops import decode_matmul as ref_decode_matmul  # noqa: E402
from repro.memstore import (CodedKVStore as RefKV,  # noqa: E402
                            CompressedParamStore as RefStore)
from repro.models import (BlockGroup as RefGroup,  # noqa: E402
                          ModelConfig as RefConfig, model_init as ref_init,
                          prefill as ref_prefill)
from repro.serve.engine import (Engine as RefEngine,  # noqa: E402
                                ServeConfig as RefServe)

from repro_torch.checkpoint import (load_compressed_store,  # noqa: E402
                                    save_compressed)
from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.core.encoder import (PREFIX_BITS,  # noqa: E402
                                      canonical_prefix_table,
                                      canonical_window_tables)
from repro_torch.core.huffman import canonical_decode_tables  # noqa: E402
from repro_torch.checkpoint.ckpt import _flatten  # noqa: E402
from repro_torch.kernels.decode_matmul import (GROUP,  # noqa: E402
                                               grouped_product)
from repro_torch.memstore import CodedKVStore, CompressedParamStore  # noqa: E402
from repro_torch.models import (BlockGroup, ModelConfig,  # noqa: E402
                                decode_step, prefill)
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(1)

CODECS = ("huffman", "qlc")
MEMCK = dict(d_model=128, vocab_size=512, n_heads=4, n_kv_heads=2,
             head_dim=32, d_ff=256)
PROMPT = np.random.default_rng(0).integers(0, 512, (2, 8)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _model():
    """(reference cfg, port cfg, reference params, port params): the
    reference's tree of shapes, filled from a seeded numpy generator
    (bf16 weights, float32 norm scales), handed to both packages."""
    rcfg = RefConfig(name="memck", arch_type="dense",
                     blocks=(RefGroup(("attn",), 2),), **MEMCK)
    tcfg = ModelConfig(name="memck", arch_type="dense",
                       blocks=(BlockGroup(("attn",), 2),), **MEMCK)
    shapes = jax.eval_shape(lambda: ref_init(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(leaf):
        a = rng.normal(0.0, 0.05, leaf.shape).astype(np.float32)
        return jnp.asarray(a, leaf.dtype)

    rparams = jax.tree_util.tree_map(draw, shapes)
    return rcfg, tcfg, rparams, from_jax_params(jax.device_get(rparams),
                                                tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _stores(codec):
    _, _, rparams, tparams = _model()
    return (RefStore.from_tree(rparams, codec=codec),
            CompressedParamStore.from_tree(tparams, codec=codec,
                                           device="cpu"))


@functools.lru_cache(maxsize=None)
def _ref_tokens():
    rcfg, _, rparams, _ = _model()
    toks, _ = RefEngine(rparams, rcfg, RefServe(max_cache_len=32)).generate(
        jnp.asarray(PROMPT), 8)
    return np.asarray(toks)


def _assert_trees_equal(got, want):
    """Port tree == port tree, bit for bit."""
    g, w = _flatten(got), _flatten(want)
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k].view(torch.uint8), w[k].view(torch.uint8)), k


@pytest.mark.parametrize("codec", CODECS)
def test_store_equals_reference(codec):
    rs, ts = _stores(codec)
    assert ts.names() == rs.names()
    for name in rs.names():
        re, te = rs.entries[name], ts.entries[name]
        assert type(te).__name__ == type(re).__name__, name
        for p, ps in getattr(re, "planes", {}).items():
            np.testing.assert_array_equal(
                te.planes[p].words.numpy().view(np.uint32), ps.words)
            np.testing.assert_array_equal(te.planes[p].bit_counts,
                                          ps.bit_counts)
            np.testing.assert_array_equal(
                te.planes[p].blocks().numpy().view(np.uint32), ps.blocks())
    assert ts.footprint() == rs.footprint()
    assert ts.footprint()["ratio"] < 0.85


def _decode_matmul_against_reference(codec, k_rows, n_cols, chunk, seed):
    """Port store.matmul (B7/B8's plain versions on the CPU) against the
    reference's ``decode_matmul`` on the same seeded weight and x: the
    coded planes word for word, the decoded tiles bit for bit, the
    product at float32 tolerance (the two add the same exact products in
    different orders).  Returns the port's lo words."""
    rng = np.random.default_rng(seed)
    w32 = rng.normal(0, 0.02, (k_rows, n_cols)).astype(np.float32)
    x32 = rng.normal(0, 1.0, (4, k_rows)).astype(np.float32)
    w, x = (torch.from_numpy(a).to(torch.bfloat16) for a in (w32, x32))
    rw, rx = (jnp.asarray(a, jnp.bfloat16) for a in (w32, x32))
    rs = RefStore.from_tree({"w": rw}, codec=codec, chunk=chunk, min_size=1)
    ts = CompressedParamStore.from_tree({"w": w}, codec=codec, chunk=chunk,
                                        min_size=1, device="cpu")
    lo, hi, counts = ts.plane_blocks("w")
    rlo, rhi, rcounts = rs.plane_blocks("w")
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), rlo)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), rhi)
    got, tiles = ts.matmul(x, "w", tiles=True)
    # decoded tiles: the reference's decode of the same planes (the
    # weight itself), then bf16 zeros of the tail slack
    size = k_rows * n_cols
    flat = tiles.reshape(-1)
    want_w = np.asarray(rs.materialize("w")).view(np.uint16).reshape(-1)
    np.testing.assert_array_equal(
        flat[:size].view(torch.int16).numpy().view(np.uint16), want_w)
    assert torch.equal(flat[:size].view(torch.int16),
                       w.reshape(-1).view(torch.int16))
    assert not flat[size:].view(torch.int16).any()
    want = ref_decode_matmul(rx, rlo, rhi, rcounts, rs.books, chunk=chunk,
                             n_cols=n_cols, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got.numpy(), x.float().numpy() @
                               w.float().numpy(), rtol=1e-5, atol=1e-6)
    return lo


@pytest.mark.parametrize("codec", CODECS)
def test_decode_matmul_plain_against_reference(codec):
    """The odd 37 x 10 weight at chunk 70 (6 chunks, a tail chunk, one
    group)."""
    lo = _decode_matmul_against_reference(codec, 37, 10, 70, seed=1)
    assert lo.shape[0] == 6


@pytest.mark.parametrize("codec", CODECS)
def test_decode_matmul_plain_against_reference_across_groups(codec):
    """The odd 303 x 10 weight at chunk 70: 44 chunks, so two groups (the
    second a ragged 12), ending in a tail chunk of 20 symbols."""
    lo = _decode_matmul_against_reference(codec, 303, 10, 70, seed=3)
    assert lo.shape[0] > GROUP                    # more than one group
    assert lo.shape[0] % GROUP != 0 and 303 * 10 % 70 != 0


def test_grouped_product_sums_in_the_documented_order():
    """The kernels' sum order, spelled out in float32 scalars: per group
    of GROUP chunks, acc = 0, then acc = acc + x * w for each row-in-chunk
    j and, inside it, each chunk of the group; then the groups in order.
    For rows = 1 (an FFN matrix's layout) and rows = 3, over two full
    groups and a ragged tail group of one chunk."""
    rng = np.random.default_rng(2)
    f32 = np.float32
    n_cols, nb, m = 2, 2 * GROUP + 1, 2
    for rows in (1, 3):
        w = torch.from_numpy(rng.normal(0, 1, (nb, rows * n_cols)).astype(
            np.float32)).to(torch.bfloat16)
        x = torch.from_numpy(rng.normal(0, 1, (m, nb * rows)).astype(
            np.float32))
        got = grouped_product(x, w, n_cols).numpy()
        wf = w.float().reshape(nb * rows, n_cols).numpy()
        xf = x.numpy()
        for i in range(m):
            for n in range(n_cols):
                out = f32(0)
                for g0 in range(0, nb, GROUP):
                    acc = f32(0)
                    for j in range(rows):
                        for c in range(g0, min(g0 + GROUP, nb)):
                            r = c * rows + j
                            acc = f32(acc + f32(xf[i, r] * wf[r, n]))
                    out = f32(out + acc)
                assert got[i, n].view(np.int32) == out.view(np.int32), rows


def _prefix_cases():
    """(name, canonical tables, max_len): seeded books with codes longer
    than PREFIX_BITS, a bf16-weight-like book, a short book (max_len 10)
    and a one-symbol book."""
    rng = np.random.default_rng(5)
    heavy = (rng.pareto(0.5, 256) * 10).astype(np.int64) + 1
    normal = np.bincount(np.clip(rng.normal(128, 12, 200_000), 0, 255)
                         .astype(np.int64), minlength=256)
    one = np.zeros(256, np.int32)
    one[7] = 1
    books = [build_codebook(heavy), build_codebook(normal),
             build_codebook(heavy, max_len=10)]
    return [("heavy", books[0].tables, 16, books[0]),
            ("normal", books[1].tables, 16, books[1]),
            ("short", books[2].tables, 10, books[2]),
            ("one_symbol", canonical_decode_tables(one), 16, None)]


@pytest.mark.parametrize("case", range(4))
def test_prefix_table_equals_canonical_walk(case):
    """B7's one-lookup table, built by the plain code, against the plain
    canonical search (``canonical_first`` over lengths 1..max_len, with
    sorted_symbols padded to 256 as the kernel holds them) at every
    max_len-bit window: a decided entry gives its (length, symbol); an
    undecided one (0) exactly where no code of at most PREFIX_BITS bits
    starts the window, which the kernel sends to that search.  The
    books' cached copies (``device_tables("prefix")``) are the same."""
    name, tb, max_len, book = _prefix_cases()[case]
    ss = np.zeros(256, np.int32)
    ss[:tb.sorted_symbols.size] = tb.sorted_symbols
    tables = tuple(torch.from_numpy(np.asarray(a, np.int32)) for a in
                   (tb.first_code, tb.base_index, tb.num_codes, ss))
    tab = canonical_prefix_table(tables, max_len).to(torch.int64)
    assert tab.shape == (1 << PREFIX_BITS,)
    want_len, want_sym = canonical_window_tables(tables, 1, max_len)
    k = PREFIX_BITS
    if max_len >= k:
        e = tab[torch.arange(1 << max_len) >> (max_len - k)]
        fast = e != 0
        assert torch.equal(e[fast] >> 8, want_len[fast])
        assert torch.equal(e[fast] & 0xFF, want_sym[fast])
        wins = torch.arange(1 << max_len)
        short = torch.zeros(1 << max_len, dtype=torch.bool)
        for ln in range(1, k + 1):
            off = (wins >> (max_len - ln)) - int(tb.first_code[ln])
            short |= (off >= 0) & (off < int(tb.num_codes[ln]))
        assert torch.equal(fast, short), name
    else:
        win = torch.arange(1 << k) >> (k - max_len)
        assert torch.equal(tab >> 8, want_len[win])
        assert torch.equal(tab & 0xFF, want_sym[win])
    if name in ("heavy", "one_symbol"):
        assert bool((tab == 0).any())        # the slow path is reached
    if book is not None:
        (cached,) = book.device_tables("prefix", "cpu")
        assert torch.equal(cached.to(torch.int64), tab)


@pytest.mark.parametrize("codec", CODECS)
def test_kv_round_trip_and_ledger_equal_reference(codec):
    rcfg, tcfg, rparams, tparams = _model()
    _, rcache = ref_prefill(rparams, {"tokens": jnp.asarray(PROMPT)}, rcfg,
                            32)
    rkv = RefKV(codec=codec, chunk=96)
    rkv.ingest(rcache)
    # the reference's cache as the port's tree: both stores code the
    # same bytes
    node = rcache[0][0]
    cache = ((tree_map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"),
                       dict(node)),),)
    kv = CodedKVStore(codec=codec, chunk=96, device="cpu")
    slots = int((np.asarray(node["pos"]) >= 0).any(0).sum())
    assert kv.ingest(cache) == slots
    back = kv.read(cache)
    _assert_trees_equal(back, cache)
    # one segment: its K and V streams, each whole chunks of 96
    k = cache[0][0]["k"]
    per_slot = k.numel() // k.shape[-3]
    assert list(kv.last_read_chunks.values()) == [
        2 * -(-slots * per_slot // 96)]
    assert (kv.kv_hbm_raw_bits, kv.kv_hbm_coded_bits) == (
        rkv.kv_hbm_raw_bits, rkv.kv_hbm_coded_bits)
    for p in ("lo", "hi"):
        np.testing.assert_array_equal(kv.books[p].lengths,
                                      rkv.books[p].lengths)

    # a decode step on the round-tripped cache: bit-identical logits
    logits, raw = prefill(tparams, {"tokens": torch.from_numpy(PROMPT)},
                          tcfg, 32)
    kv2 = CodedKVStore(codec=codec, chunk=96, device="cpu")
    kv2.ingest(raw)
    rt = kv2.read(raw)
    tok = logits[:, -1].argmax(-1)[:, None]
    want, _ = decode_step(tparams, tok, raw, PROMPT.shape[1], tcfg)
    got, _ = decode_step(tparams, tok, rt, PROMPT.shape[1], tcfg)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("codec", CODECS)
def test_coded_serve_materializes_and_tokens_equal_raw_and_reference(codec):
    _, tcfg, _, tparams = _model()
    sc = ServeConfig(max_cache_len=32)
    raw, _ = Engine(tparams, tcfg, sc, device="cpu").generate(PROMPT, 8)
    eng = Engine(None, tcfg, sc, param_store=_stores(codec)[1],
                 kv_mode="coded", device="cpu")
    # decode-on-load: the store's materialize_tree, bit for bit
    _assert_trees_equal(eng.params, tparams)
    toks, totals = eng.generate(PROMPT, 8)
    np.testing.assert_array_equal(toks, raw)
    np.testing.assert_array_equal(toks, _ref_tokens())
    for k in ("param_hbm_raw_bits", "param_hbm_coded_bits",
              "kv_hbm_raw_bits", "kv_hbm_coded_bits"):
        assert totals[k] > 0, k
    assert totals["hbm_coded_bits"] < totals["hbm_raw_bits"]
    with pytest.raises(ValueError, match="either"):
        Engine(tparams, tcfg, sc, param_store=_stores(codec)[1],
               device="cpu")
    # books from a spec's plane lengths come first (here the store's)
    spec = CompressionSpec.from_books(_stores(codec)[1].books, "bf16")
    eng = Engine(tparams, tcfg, sc, spec, kv_mode="coded", device="cpu")
    np.testing.assert_array_equal(eng.generate(PROMPT, 8)[0], raw)
    assert eng._kv.books["hi"].codec_name == codec
    with pytest.raises(ValueError, match="needs books"):
        Engine(tparams, tcfg, sc, kv_mode="coded", device="cpu")


@pytest.mark.parametrize("codec", CODECS)
def test_compressed_manifest_interchange(codec, tmp_path):
    _, _, rparams, tparams = _model()
    # reference-written manifest → port store → the same bytes
    ref_path = str(tmp_path / "ref.npz")
    ref_save(ref_path, rparams, codec=codec)
    store, _ = load_compressed_store(ref_path, tparams, expect_codec=codec,
                                     device="cpu")
    assert store.codec == codec
    _assert_trees_equal(store.materialize_tree(), tparams)
    other = "qlc" if codec == "huffman" else "huffman"
    with pytest.raises(ValueError, match=other):
        load_compressed_store(ref_path, expect_codec=other, device="cpu")
    # port-written manifest: byte for byte the reference's, and the
    # reference opens it and decodes a leaf of it
    path = str(tmp_path / "port.npz")
    save_compressed(path, tparams, codec=codec, device="cpu")
    mine, theirs = np.load(path), np.load(ref_path)
    assert sorted(mine.files) == sorted(theirs.files)
    for k in theirs.files:
        np.testing.assert_array_equal(mine[k], theirs[k], k)
    rstore, _ = ref_load(path, rparams, expect_codec=codec)
    flat = _flatten(tparams)
    name = "groups/[0]/[0]/mixer/wk"
    got = np.asarray(rstore.materialize(name)).view(np.uint16)
    assert np.array_equal(got, flat[name].view(torch.int16).numpy().view(
        np.uint16))
