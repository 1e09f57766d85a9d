"""Port parity, transports and ledger: the monolithic and chunked
transports (with the endpoint reduce_scatter / all_to_all), the
``*_compressed`` dispatch, the ledger-mode collectives and
``CollectiveLedger`` against the reference run in this process under
``jax.vmap(..., axis_name=...)``, jitted; the monolithic stream path
(encode/decode, kernel-path pack and merge) across the two packages;
``--ring-check --device cpu``; and ``ProcessGroupAxis`` on a gloo world
of two processes against ``LoopbackAxis``."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

import repro.comm as R  # noqa: E402
from repro.comm.hierarchy import hierarchical_wire_factor as ref_hwf  # noqa
from repro.comm.transport import Transport as RefTransport  # noqa: E402
from repro.core.codebook import build_codebook as ref_build  # noqa: E402
from repro.core.encoder import decode_jit as ref_decode_jit  # noqa: E402
from repro.core.encoder import encode_jit as ref_encode_jit  # noqa: E402
from repro.kernels.ops import pack_with_book as ref_pack  # noqa: E402

import repro_torch.comm as T  # noqa: E402
from repro_torch.comm import LoopbackAxis  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.core.encoder import (decode_jit, decode_with_book,  # noqa
                                      encode_jit)
from repro_torch.core.symbols import SCHEMES  # noqa: E402
from repro_torch.kernels.ops import (decode_with_book_kernel,  # noqa: E402
                                     encode_rows, merge_block_streams,
                                     pack_with_book)
from repro_torch.launch.dryrun import ring_check  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 64
F8 = ml_dtypes.float8_e4m3fn


def _data(scheme, shape, seed):
    rng = np.random.default_rng(seed)
    if scheme == "e4m3":                      # every pattern, sums past 448
        return rng.integers(0, 256, size=shape, dtype=np.uint8).view(F8)
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-6, 7, size=shape))
    return v.astype(np.float32).astype(ml_dtypes.bfloat16)


def _torch(a):
    if a.dtype == F8:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8 if a.dtype == torch.float8_e4m3fn
                   else torch.int16).numpy()
    else:
        a = np.asarray(a)
        a = a.view(np.uint8 if a.dtype == F8 else np.int16)
    return a.astype(np.int64)


def _books(x, scheme, codec="huffman"):
    rb, tb = {}, {}
    for p, s in SCHEMES[scheme].to_symbols(_torch(x)).items():
        counts = np.bincount(s.numpy()[::3], minlength=256)
        rb[p], tb[p] = (ref_build(counts, codec=codec),
                        build_codebook(counts, codec=codec))
        np.testing.assert_array_equal(rb[p].lengths, tb[p].lengths)
        np.testing.assert_array_equal(rb[p].codes, tb[p].codes)
    return rb, tb


def _ref(fn, x):
    return jax.tree.map(np.asarray,
                        jax.jit(jax.vmap(fn, axis_name="r"))(jnp.asarray(x)))


def _same(ref, got):
    (ry, rs), (ty, ts) = ref, got
    np.testing.assert_array_equal(_bits(ty), _bits(ry).reshape(
        _bits(ty).shape))
    assert set(rs) == set(ts)
    for k in rs:
        np.testing.assert_array_equal(ts[k].numpy(),
                                      np.asarray(rs[k], np.float64), k)


# ------------------------------------------------ reference runs (once)
@pytest.fixture(scope="module")
def case_bf16():
    """n = 4 gaussian bf16 (spread exponents: the endpoint peer sum is
    XLA's float32 sum rounded once), Huffman books."""
    n = 4
    x = _data("bf16", (n, 4, 50), 0)
    rb, tb = _books(x, "bf16")
    mono, chunked = R.TRANSPORTS["monolithic"], R.TRANSPORTS["chunked"]

    def body(v):
        kw = dict(chunk=CHUNK, decode_backend="scan")
        return {"mono_ag": mono.all_gather(v, "r", rb, "bf16"),
                "mono_ar": mono.all_reduce(v, "r", rb, "bf16"),
                "mono_rs": mono.reduce_scatter(v, "r", rb, "bf16"),
                "mono_a2a": mono.all_to_all(v, "r", rb, "bf16"),
                "chunked_ag": chunked.all_gather(v, "r", rb, "bf16", **kw),
                "chunked_ar": chunked.all_reduce(v, "r", rb, "bf16", **kw)}
    return x, tb, _ref(body, x)


@pytest.fixture(scope="module")
def case_e4m3():
    """n = 4 e4m3 past 448: endpoint sums add by add in e4m3.  (The
    reference's chunked transport cannot reassemble e4m3: it bitcasts
    int32 symbols to fp8; its monolithic Huffman decode gives uint8.)"""
    x = _data("e4m3", (4, 90), 1)
    rb, tb = _books(x, "e4m3")
    mono = R.TRANSPORTS["monolithic"]

    def body(v):
        return {"mono_ar": mono.all_reduce(v, "r", rb, "e4m3"),
                "mono_rs": mono.reduce_scatter(v, "r", rb, "e4m3")}
    return x, tb, _ref(body, x)


# ---------------------------------------------------------------- tests
@pytest.mark.parametrize("key", ["mono_ag", "mono_ar", "mono_rs", "mono_a2a",
                                 "chunked_ag", "chunked_ar"])
def test_endpoint_transports_bf16_equal_reference(case_bf16, key):
    x, tb, refs = case_bf16
    name, op = key.split("_")
    t = T.TRANSPORTS["monolithic" if name == "mono" else "chunked"]
    fn = {"ag": t.all_gather, "ar": t.all_reduce, "rs": t.reduce_scatter,
          "a2a": t.all_to_all}[op]
    kw = {} if name == "mono" else {"chunk": CHUNK}
    _same(refs[key], fn(_torch(x), LoopbackAxis(4), tb, "bf16", **kw))


@pytest.mark.parametrize("key", ["mono_ar", "mono_rs"])
def test_endpoint_transports_e4m3_equal_reference(case_e4m3, key):
    x, tb, refs = case_e4m3
    t = T.TRANSPORTS["monolithic"]
    fn = t.all_reduce if key == "mono_ar" else t.reduce_scatter
    got = fn(_torch(x), LoopbackAxis(4), tb, "e4m3")
    _same(refs[key], got)
    assert np.isnan(got[0].float().numpy()).any()
    if key == "mono_ar":                 # the chunked transport: the same
        ch = T.TRANSPORTS["chunked"].all_reduce(_torch(x), LoopbackAxis(4),
                                                tb, "e4m3", chunk=CHUNK)
        np.testing.assert_array_equal(_bits(ch[0]), _bits(got[0]))


def test_compressed_dispatch_and_spec_axes():
    """Each spec reaches its transport; ``spec.axes`` reaches the
    hierarchy; the endpoint transports refuse an f32 carry."""
    x = _torch(_data("bf16", (2, 2, 300), 2))
    _, tb = _books(x.view(torch.int16).numpy().view(ml_dtypes.bfloat16),
                   "bf16")
    ax = LoopbackAxis(2)
    flat = x.reshape(2, 2, 2, -1)[:, 0]
    for name in ("monolithic", "chunked", "ring"):
        spec = T.CompressionSpec.from_books(tb, "bf16", mode="bitexact",
                                            transport=name, chunk=CHUNK)
        t = T.get_transport(name)
        for entry, op in ((T.all_gather_compressed, t.all_gather),
                          (T.all_reduce_compressed, t.all_reduce),
                          (T.reduce_scatter_compressed, t.reduce_scatter),
                          (T.all_to_all_compressed, t.all_to_all)):
            got, want = entry(flat, ax, tb, spec), op(flat, ax, tb, "bf16",
                                                      chunk=CHUNK)
            assert torch.equal(got[0].view(torch.int16),
                               want[0].view(torch.int16)), (name, entry)
    mesh = T.loopback_mesh({"outer": 2, "inner": 2})
    spec = T.CompressionSpec.from_books(tb, "bf16", mode="bitexact",
                                        transport="ring", chunk=CHUNK,
                                        axes=("inner", "outer"))
    got = T.all_reduce_compressed(x, mesh, tb, spec)
    want = T.hierarchical_all_reduce(x, (mesh["inner"], mesh["outer"]), tb,
                                     "bf16", chunk=CHUNK)
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    with pytest.raises(ValueError, match="carry"):
        T.get_transport("chunked").all_reduce(flat, ax, tb, carry="f32")
    for n in (2, 3, 4, 8):
        for op in T.transport.RING_FACTORS:
            assert T.Transport.wire_factor(op, n) == \
                RefTransport.wire_factor(op, n)
        for m in (1, 2, 4):
            assert T.hierarchical_wire_factor(n, m) == ref_hwf(n, m)


def test_ledger_mode_collectives_equal_reference():
    x = _data("bf16", (4, 8, 6), 3)
    rb, tb = _books(x, "bf16")
    rspec = R.CompressionSpec.from_books(rb, "bf16", mode="ledger")
    tspec = T.CompressionSpec.from_books(tb, "bf16", mode="ledger")
    perm = [(0, 2), (2, 1), (1, 3), (3, 0)]

    def body(v):
        return {"ar": R.all_reduce(v, "r", rspec),
                "rs": R.reduce_scatter(v, "r", spec=rspec),
                "ag": R.all_gather(v, "r", axis=1, tiled=True, spec=rspec),
                "a2a": R.all_to_all(v, "r", split_axis=0, concat_axis=1,
                                    spec=rspec),
                "pp": R.ppermute(v, "r", perm, spec=rspec),
                "off": R.all_reduce(v, "r")}
    refs = _ref(body, x)
    xt, ax = _torch(x), LoopbackAxis(4)
    got = {"ar": T.all_reduce(xt, ax, tspec),
           "rs": T.reduce_scatter(xt, ax, spec=tspec),
           "ag": T.all_gather(xt, ax, axis_dim=1, tiled=True, spec=tspec),
           "a2a": T.all_to_all(xt, ax, split_axis=0, concat_axis=1,
                               spec=tspec),
           "pp": T.ppermute(xt, ax, perm, spec=tspec),
           "off": T.all_reduce(xt, ax)}
    for k in refs:
        (ry, rs), (ty, ts) = refs[k], got[k]
        np.testing.assert_array_equal(_bits(ty), _bits(ry), k)
        for s in rs:
            np.testing.assert_array_equal(
                np.broadcast_to(ts[s].numpy(), np.shape(rs[s])),
                np.asarray(rs[s], np.float64), (k, s))
    merged = T.merge_stats(got["ar"][1], got["rs"][1], T.zero_stats())
    want = R.merge_stats(refs["ar"][1], refs["rs"][1])
    for s in want:
        np.testing.assert_array_equal(merged[s].numpy(),
                                      np.asarray(want[s], np.float64))


def test_collective_ledger_equals_reference():
    stats = [("grad/all_reduce", {"raw_wire_bits": 1.5e9,
                                  "coded_wire_bits": 1.1e9}),
             ("act/all_gather", {"raw_wire_bits": 3e8,
                                 "coded_wire_bits": torch.tensor(2.5e8)}),
             ("grad/all_reduce", {"raw_wire_bits": 5e8,
                                  "coded_wire_bits": 4e8}),
             ("empty", {})]
    ref, got = R.CollectiveLedger(), T.CollectiveLedger()
    for label, s in stats:
        ref.record(label, {k: float(v) for k, v in s.items()})
        got.record(label, s)
    got.record_tree({"x": {"raw_wire_bits": 8.0}})
    ref.record_tree({"x": {"raw_wire_bits": 8.0}})
    assert got.summary() == ref.summary()
    assert got.report() == ref.report()
    assert got.overall_ratio() == ref.overall_ratio()


@pytest.mark.parametrize("n", [1, 5000])
def test_monolithic_stream_crosses_packages(n):
    """encode_jit, the kernel path (B1 → B2 → merge) and decode_jit, each
    package's stream decoded by the other."""
    rng = np.random.default_rng(n)
    sym = (rng.standard_normal(n) * 12).astype(np.int64).astype(np.uint8)
    counts = np.bincount(sym[::2], minlength=256)
    rb, tb = ref_build(counts), build_codebook(counts)
    rw, rbits = ref_encode_jit(jnp.asarray(sym), jnp.asarray(rb.codes),
                               jnp.asarray(rb.lengths))
    tw, tbits = encode_jit(torch.from_numpy(sym), tb.codes, tb.lengths)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(rw))
    assert int(tbits) == int(rbits)
    pw, pbits = ref_pack(jnp.asarray(sym), rb)
    qw, qbits = pack_with_book(torch.from_numpy(sym), tb)
    assert qbits == pbits
    np.testing.assert_array_equal(qw.numpy().view(np.uint32), pw)
    t = tb.tables
    np.testing.assert_array_equal(np.asarray(ref_decode_jit(
        jnp.asarray(tw.numpy().view(np.uint32)), jnp.asarray(t.first_code),
        jnp.asarray(t.base_index), jnp.asarray(t.num_codes),
        jnp.asarray(t.sorted_symbols), n)), sym)
    port_words = torch.from_numpy(np.array(rw).view(np.int32))
    np.testing.assert_array_equal(decode_with_book(port_words, tb, n).numpy(),
                                  sym)
    np.testing.assert_array_equal(decode_jit(
        port_words, t.first_code, t.base_index, t.num_codes,
        t.sorted_symbols, n).numpy(), sym)
    words, bits = encode_rows(torch.from_numpy(sym)[None],
                              tb.device_tables("lut", "cpu")[0], chunk=2048,
                              max_len=tb.max_len)
    np.testing.assert_array_equal(
        decode_with_book_kernel((words, bits), tb, n).numpy(), sym)
    merged, total = merge_block_streams(words, bits)
    assert total == int(tbits)
    assert torch.equal(merged[:tw.shape[0]], tw[:merged.shape[0]])


def test_ring_check_cpu():
    rec = ring_check(4, device="cpu", verbose=False)
    assert rec["status"] == "ok", rec
    assert rec["ar_hops"] == 6 and rec["hier_hops"] == 4


_GLOO = r"""
import json, sys, numpy as np, torch, torch.distributed as dist
from repro_torch.comm import ProcessGroupAxis, ring_all_reduce, ring_all_to_all
from repro_torch.core.codebook import build_codebook
from repro_torch.core.symbols import SCHEMES
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
x = torch.from_numpy(np.load(out + ".x.npy")).view(torch.bfloat16)
books = {p: build_codebook(np.bincount(s.numpy(), minlength=256))
         for p, s in SCHEMES["bf16"].to_symbols(x).items()}
ax = ProcessGroupAxis()
res = {"ar": ring_all_reduce(x[rank], ax, books, chunk=64),
       "ar_f32": ring_all_reduce(x[rank], ax, books, chunk=64, carry="f32"),
       "a2a": ring_all_to_all(x[rank].reshape(2, -1), ax, books, chunk=64)}
torch.save({k: (y.view(torch.int16), {s: v for s, v in st.items()})
            for k, (y, st) in res.items()}, f"{out}.{rank}.pt")
dist.destroy_process_group()
"""


def test_process_group_axis_equals_loopback(tmp_path):
    """ProcessGroupAxis on a gloo world of two processes: the same
    results and stats as LoopbackAxis."""
    import socket
    x = _data("bf16", (2, 250), 4)
    np.save(tmp_path / "run.x.npy", x.view(np.int16))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r), str(port),
                               str(tmp_path / "run")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    xt = _torch(x)
    books = {p: build_codebook(np.bincount(s.numpy(), minlength=256))
             for p, s in SCHEMES["bf16"].to_symbols(xt).items()}
    ax = LoopbackAxis(2)
    want = {"ar": T.ring_all_reduce(xt, ax, books, chunk=64),
            "ar_f32": T.ring_all_reduce(xt, ax, books, chunk=64,
                                        carry="f32"),
            "a2a": T.ring_all_to_all(xt.reshape(2, 2, -1), ax, books,
                                     chunk=64)}
    for r in range(2):
        got = torch.load(tmp_path / f"run.{r}.pt")
        for k, (y, st) in want.items():
            assert torch.equal(got[k][0], y[r].view(torch.int16)), (r, k)
            assert set(got[k][1]) == set(st)
            for s, v in st.items():
                assert torch.equal(got[k][1][s], v[r]), (r, k, s)
