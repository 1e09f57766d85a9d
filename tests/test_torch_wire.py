"""Port parity, wire format: ``encode_chunked`` against the reference's
``encode_chunked_jit`` word for word, streams decoding across packages
in both directions, plus the port's structural rules (no JAX import,
entry points that ask for the card)."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.codebook import build_codebook as ref_build  # noqa: E402
from repro.core.encoder import (ChunkedStream as RefStream,  # noqa: E402
                                decode_chunked as ref_decode_chunked,
                                encode_chunked_jit, recode_chunks_jit)

from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.core.encoder import (ChunkedStream,  # noqa: E402
                                      chunk_counts_for, decode_chunked,
                                      decode_dispatch, decode_np,
                                      encode_chunked, encode_chunked_rows,
                                      encode_np, recode_chunks)
from repro_torch.core.symbols import SCHEMES  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ("multisym", "scan", "pallas", "multisym_pallas")


def _planes(scheme, n, seed):
    """Byte planes of seeded activations-like data, as uint8 arrays."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.choice([0.01, 1, 30], n)).astype(
        np.float32)
    if scheme == "e4m3":
        x = np.clip(x, -440, 440)
    return {p: s.numpy() for p, s in
            SCHEMES[scheme].to_symbols(torch.from_numpy(x)).items()}


def _book_pair(sym):
    counts = np.bincount(sym, minlength=256)
    return ref_build(counts, codec="huffman"), build_codebook(
        counts, codec="huffman")


@pytest.mark.parametrize("chunk", [31, 1001, 2048])
@pytest.mark.parametrize("scheme", ["bf16", "e4m3"])
def test_encode_chunked_words_equal_reference(scheme, chunk):
    for plane, sym in _planes(scheme, 5000, chunk).items():
        rb, tb = _book_pair(sym[::3])            # books from "earlier" data
        rw, rbits = encode_chunked_jit(jnp.asarray(sym), jnp.asarray(rb.codes),
                                       jnp.asarray(rb.lengths), chunk=chunk)
        st = encode_chunked(sym, tb, chunk=chunk, device="cpu")
        np.testing.assert_array_equal(st.block_words.numpy().view(np.uint32),
                                      np.asarray(rw), plane)
        np.testing.assert_array_equal(st.block_bits.numpy(), np.asarray(rbits))
        w, b = encode_chunked_rows(torch.from_numpy(sym),
                                   torch.from_numpy(tb.codes.astype(np.int64)),
                                   torch.from_numpy(tb.lengths), chunk=chunk)
        assert torch.equal(w, st.block_words) and torch.equal(b, st.block_bits)


@pytest.mark.parametrize("chunk", [31, 2048])
def test_streams_decode_across_packages(chunk):
    sym = _planes("bf16", 2100, 7)["hi"]
    rb, tb = _book_pair(sym)
    # reference-encoded → port-decoded, every backend
    rw, rbits = encode_chunked_jit(jnp.asarray(sym), jnp.asarray(rb.codes),
                                   jnp.asarray(rb.lengths), chunk=chunk)
    st = ChunkedStream(torch.from_numpy(np.array(rw).view(np.int32)),
                       torch.from_numpy(np.array(rbits)), sym.shape[0], chunk)
    for backend in BACKENDS:
        np.testing.assert_array_equal(
            decode_chunked(st, tb, backend=backend).numpy(), sym, backend)
    # port-encoded → reference-decoded
    mine = encode_chunked(sym, tb, chunk=chunk, device="cpu")
    rs = RefStream(jnp.asarray(mine.block_words.numpy().view(np.uint32)),
                   jnp.asarray(mine.block_bits.numpy()), sym.shape[0], chunk)
    for backend in ("scan", "multisym"):
        np.testing.assert_array_equal(
            np.asarray(ref_decode_chunked(rs, rb, backend=backend)), sym)


def test_recode_and_monolithic_paths():
    sym = _planes("bf16", 3000, 11)["lo"]
    rb, tb = _book_pair(sym)
    chunk = 1001
    blocks = np.zeros((3, chunk), np.int32)
    blocks.reshape(-1)[:3000] = sym
    counts = chunk_counts_for(3000, chunk)
    rw, rbits = recode_chunks_jit(jnp.asarray(blocks), jnp.asarray(counts),
                                  jnp.asarray(rb.codes),
                                  jnp.asarray(rb.lengths))
    tw, tbits = recode_chunks(torch.from_numpy(blocks),
                              torch.from_numpy(counts),
                              torch.from_numpy(tb.codes.astype(np.int64)),
                              torch.from_numpy(tb.lengths))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(rw))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(rbits))
    # A monolithic stream (encode_np) is one chunk of n symbols.
    words, n_bits = encode_np(sym[:700], tb.codes, tb.lengths)
    cap = (700 * 16 + 31) // 32 + 1
    buf = np.zeros(cap, np.uint32)
    buf[:words.shape[0]] = words
    got = decode_dispatch(torch.from_numpy(buf.view(np.int32)), tb, 700)
    np.testing.assert_array_equal(got.numpy(), sym[:700])
    np.testing.assert_array_equal(decode_np(words, 700, tb), sym[:700])


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro",
                                           "ml_dtypes")]
    assert not bad, bad
    assert len(_port_files()) > 20


def test_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.models import init_caches, model_init
    from repro_torch.serve import Engine, ServeConfig
    book = build_codebook(np.ones(256, np.int64))
    sym = np.zeros(10, np.uint8)
    calls = [lambda: encode_chunked(sym, book),
             lambda: model_init(get_config("gemma2-2b"), torch.Generator()),
             lambda: init_caches(get_config("gemma2-2b"), 1, 8),
             lambda: Engine({"embed": {"table": torch.zeros(1)}},
                            get_config("gemma2-2b"), ServeConfig(8))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert encode_chunked(sym, book, device="cpu").n_symbols == 10
