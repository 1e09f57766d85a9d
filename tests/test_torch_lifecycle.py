"""Port parity, codebook lifecycle: ``repro_torch.lifecycle`` (monitor,
manager, sync), ``launch.dryrun.drift_check`` and ``Engine(lifecycle=)``
against the JAX reference on the CPU.

The monitor and manager are host numpy in float64 in both packages, so
their reports, stale keys, epochs, content hashes and books are held
*equal*.  The reference's ``drift_check`` needs n JAX devices; here its
decisions are reproduced with the reference's lifecycle objects on the
same seeded payloads, and its coded ring bits by the reference's
``ring_all_reduce`` under ``jax.vmap(..., axis_name=...)`` (jitted once
for both books), as ``tests/test_torch_ring.py`` runs the rings.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm.ring import ring_all_reduce as ref_ring  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.codebook import build_codebook as ref_build  # noqa: E402
from repro.core.symbols import bf16_planes_np  # noqa: E402
from repro.lifecycle import (BookLifecycleManager as RefManager,  # noqa
                             DriftMonitor as RefMonitor,
                             DriftThresholds as RefThresholds,
                             epoch_fingerprint as ref_fingerprint)
from repro.serve.engine import (Engine as RefEngine,  # noqa: E402
                                ServeConfig as RefServe)

from repro_torch.comm import LoopbackAxis  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.launch.dryrun import drift_check  # noqa: E402
from repro_torch.lifecycle import (BookLifecycleManager,  # noqa: E402
                                   DriftMonitor, DriftThresholds,
                                   EpochSyncError, epoch_fingerprint,
                                   verify_epoch_agreement)
from repro_torch.models import model_init  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

torch.set_num_threads(1)

KEY = ("grad", "bf16", "hi")


def _hist(seed, support=slice(0, 128), total=1 << 14):
    """A seeded histogram with its mass on ``support``."""
    rng = np.random.default_rng(seed)
    h = np.zeros(256, np.int64)
    n = support.stop - support.start
    h[support] = np.round(rng.dirichlet(np.full(n, 0.5)) * total)
    return h


def _report(r):
    d = dataclasses.asdict(r)
    d["key"] = tuple(d["key"])
    return d


# ------------------------------------------------------------- monitor
@pytest.mark.parametrize("patience,min_symbols", [(1, 1), (3, 1),
                                                  (2, 1 << 15)])
def test_drift_monitor_reports_equal_reference(patience, min_symbols):
    """Seeded windows (own source, drifting mixtures, a disjoint shift,
    a healthy window that resets the streak, one small window): every
    report equal field for field, and the stale keys after each."""
    base = _hist(3)
    rb = ref_build(base, key=KEY)
    tb = build_codebook(base, key=KEY)
    th = dict(patience=patience, min_symbols=min_symbols)
    rmon, tmon = RefMonitor(RefThresholds(**th)), DriftMonitor(
        DriftThresholds(**th))
    far = _hist(4, slice(128, 256))
    windows = [rb.source_counts, *[(1 - t) * base + t * far
                                   for t in (0.1, 0.5, 1.0)],
               far, far, rb.source_counts, far, np.full(256, 2)]
    for w in windows:
        r = rmon.observe(KEY, w, rb)
        t = tmon.observe(KEY, w, tb)
        assert _report(t) == _report(r)
        assert tmon.stale_keys() == rmon.stale_keys()
    assert tmon.n_windows == rmon.n_windows
    assert tmon.total_realized_bits == rmon.total_realized_bits
    assert tmon.total_shannon_bits == rmon.total_shannon_bits


# ------------------------------------------------------------- manager
def _managers(ema_seed=0, **th):
    rm = RefManager(thresholds=RefThresholds(**th))
    tm = BookLifecycleManager(thresholds=DriftThresholds(**th))
    for plane, seed in (("lo", ema_seed), ("hi", ema_seed + 1)):
        for m in (rm, tm):
            m.install(("grad", "bf16", plane), _hist(seed))
    return rm, tm


def _same_state(rm, tm):
    assert tm.book_epoch == rm.book_epoch
    assert tm.snapshot.content_hash == rm.snapshot.content_hash
    assert tm.snapshot.keys() == rm.snapshot.keys()
    for rb, tb in zip(rm.snapshot.books, tm.snapshot.books):
        assert tb.book_id == rb.book_id
        np.testing.assert_array_equal(tb.lengths, rb.lengths)
        np.testing.assert_array_equal(tb.source_counts, rb.source_counts)


def test_manager_observe_stale_refresh_flow_equals_reference():
    rm, tm = _managers(min_symbols=1, patience=2)
    _same_state(rm, tm)
    for step in range(6):
        metrics = {"loss": 1.0,
                   "grad_hist_lo": _hist(10 + step, slice(64, 256)),
                   "grad_hist_hi": _hist(20 + step, slice(100, 200))}
        rr = rm.observe_train_metrics(metrics)
        tr = tm.observe_train_metrics(
            {k: torch.from_numpy(np.asarray(v)) if k != "loss" else v
             for k, v in metrics.items()})
        assert {p: _report(r) for p, r in tr.items()} == {
            p: _report(r) for p, r in rr.items()}
        assert tm.stale_keys() == rm.stale_keys()
        if step % 2:
            assert tm.maybe_refresh() == rm.maybe_refresh()
            _same_state(rm, tm)
    assert tm.n_refreshes == rm.n_refreshes >= 1
    assert tm.maybe_refresh(force=True) == rm.maybe_refresh(force=True)
    _same_state(rm, tm)
    assert (tm.books("grad")["hi"].lengths
            == rm.books("grad")["hi"].lengths).all()


def test_compiled_cache_and_spec_respec_equal_reference():
    rm, tm = _managers()
    built = {"ref": 0, "port": 0}

    def builder(tag):
        def build(mgr):
            built[tag] += 1
            return (tag, mgr.book_epoch)
        return build

    for _ in range(2):                        # cached within an epoch
        assert tm.compiled("step", builder("port"))[1] == tm.book_epoch
        rm.compiled("step", builder("ref"))
    tm.compiled("other", builder("port"))
    rm.compiled("other", builder("ref"))
    s1 = tm.spec("grad", "bf16", mode="bitexact", transport="ring",
                 chunk=128)
    r1 = rm.spec("grad", "bf16", mode="bitexact", transport="ring",
                 chunk=128)
    assert tm.spec("grad", "bf16", mode="bitexact", transport="ring",
                   chunk=128) is s1
    assert tm.respec(s1) == s1                # same epoch, same books
    for m in (rm, tm):
        m.maybe_refresh(force=True)
    s2, r2 = tm.respec(s1), rm.respec(r1)
    tm.compiled("step", builder("port"))
    rm.compiled("step", builder("ref"))
    assert built["port"] == built["ref"] == tm.n_recompiles \
        == rm.n_recompiles == 3
    for s, r in ((s1, r1), (s2, r2)):
        assert (s.book_epoch, s.plane_lengths, s.book_ids, s.mode,
                s.transport, s.chunk, s.codec, s.decode_backend) == (
            r.book_epoch, r.plane_lengths, r.book_ids, r.mode, r.transport,
            r.chunk, r.codec, r.decode_backend)
    assert s2.book_epoch == s1.book_epoch + 1


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_load_across_packages(tmp_path, writer):
    rm, tm = _managers(ema_seed=5)
    for m in (rm, tm):
        m.observe(("grad", "bf16", "hi"), _hist(9, slice(0, 64)))
        m.maybe_refresh(force=True)
    rdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    rm.save(rdir)
    tm.save(tdir)
    for name in ("manifest.json",):
        with open(os.path.join(rdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read()
    src = tdir if writer == "port" else rdir
    back_r = RefManager.load(src)
    back_t = BookLifecycleManager.load(src)
    _same_state(back_r, back_t)
    _same_state(rm, back_t)
    # tamper: a manifest from another epoch is refused by both
    mpath = os.path.join(src, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["book_epoch"] += 1
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    for cls in (RefManager, BookLifecycleManager):
        with pytest.raises(ValueError, match="epoch"):
            cls.load(src)


# ---------------------------------------------------------------- sync
def test_epoch_fingerprint_equals_reference():
    rm, tm = _managers()
    for m in (rm, tm):
        m.observe(("grad", "bf16", "lo"), _hist(7))
        m.maybe_refresh(force=True)
    for r, t in ((rm, tm), (rm.snapshot, tm.snapshot),
                 (rm.registry, tm.registry)):
        fr, ft = ref_fingerprint(r), epoch_fingerprint(t)
        assert ft.dtype == np.uint32 and ft.shape == (2,)
        np.testing.assert_array_equal(ft, fr)


@pytest.mark.parametrize("wire", ["books", "spec"])
def test_epoch_fingerprint_folds_the_a2a_wire_like_reference(wire):
    """With the MoE all-to-all wire configured in both packages (books,
    or a bitexact spec), the fingerprints still agree, and differ from
    the unconfigured ones: the wire's books are part of the epoch."""
    from repro.comm.compression import CompressionSpec as RefSpec
    from repro.models import moe as ref_moe

    from repro_torch.comm.compression import CompressionSpec
    from repro_torch.models import moe

    rm, tm = _managers()
    before = epoch_fingerprint(tm)
    saved = (dict(ref_moe._A2A_WIRE), dict(moe._A2A_WIRE))
    try:
        h = {"lo": _hist(11), "hi": _hist(12, slice(0, 256))}
        rb = {p: ref_build(c) for p, c in h.items()}
        tb = {p: build_codebook(c) for p, c in h.items()}
        if wire == "books":
            ref_moe.configure_a2a_wire(rb, chunk=1024)
            moe.configure_a2a_wire(tb, chunk=1024)
        else:
            ref_moe.configure_a2a_wire(spec=RefSpec.from_books(
                rb, "bf16", mode="bitexact"))
            moe.configure_a2a_wire(spec=CompressionSpec.from_books(
                tb, "bf16", mode="bitexact"))
        ft = epoch_fingerprint(tm)
        np.testing.assert_array_equal(ft, ref_fingerprint(rm))
        assert ft[1] != before[1] and ft[0] == before[0]
    finally:
        for mod, old in zip((ref_moe, moe), saved):
            mod._A2A_WIRE.clear()
            mod._A2A_WIRE.update(old)


@pytest.mark.parametrize("over", ["host", "loopback"])
def test_verify_epoch_agreement_unanimous_passes_laggard_raises(over):
    rm, tm = _managers()
    snap0 = tm.snapshot
    tm.maybe_refresh(force=True)
    fp = epoch_fingerprint(tm)
    n = 4
    axis = LoopbackAxis(n) if over == "loopback" else None
    verify_epoch_agreement(np.tile(fp, (n, 1)), axis, device="cpu")
    mixed = np.tile(fp, (n, 1))
    mixed[2] = epoch_fingerprint(snap0)
    with pytest.raises(EpochSyncError, match="disagree"):
        verify_epoch_agreement(mixed, axis, device="cpu")
    # same epoch, other content: the digest catches it
    other = mixed.copy()
    other[2] = [fp[0], fp[1] ^ 1]
    with pytest.raises(EpochSyncError):
        verify_epoch_agreement(other, axis, device="cpu")
    if axis is not None and not torch.cuda.is_available():
        # an entry point: the axis path runs on CUDA unless told otherwise
        with pytest.raises(RuntimeError, match="CUDA"):
            verify_epoch_agreement(np.tile(fp, (n, 1)), axis)
    else:   # the host path compares numpy and takes no device
        verify_epoch_agreement(np.tile(fp, (n, 1)), axis)


# ---------------------------------------------------------- drift check
def test_drift_check_on_the_cpu_equals_reference():
    n, payload, chunk = 4, 4096, 512
    rec = drift_check(n=n, payload=payload, chunk=chunk, device="cpu",
                      verbose=False)
    assert rec["status"] == "ok"
    assert all(v for k, v in rec.items() if isinstance(v, bool)), rec

    # the reference's lifecycle objects on the same payloads
    rng = np.random.default_rng(0)
    base = rng.integers(-2, 3, size=(n, payload)).astype(ml_dtypes.bfloat16)
    shifted = rng.integers(-32, 33, size=(n, payload)).astype(
        ml_dtypes.bfloat16)
    mgr = RefManager(thresholds=RefThresholds(
        kl_bits=0.05, excess_bits=0.05, min_symbols=1024, patience=2))
    for plane, sym in bf16_planes_np(base).items():
        mgr.install(("act", "bf16", plane), np.bincount(sym, minlength=256))
    snap0 = mgr.snapshot
    windows = 0
    while not mgr.stale_keys() and windows < 6:
        for plane, sym in bf16_planes_np(shifted).items():
            mgr.observe(("act", "bf16", plane),
                        np.bincount(sym, minlength=256))
        windows += 1
    new_epoch = mgr.maybe_refresh()
    assert (rec["stale_windows_to_signal"], rec["epoch_before"],
            rec["epoch_after"]) == (windows, snap0.epoch, new_epoch)
    assert rec["content_hash_before"] == snap0.content_hash
    assert rec["content_hash_after"] == mgr.snapshot.content_hash

    old = {p: snap0.get(("act", "bf16", p)) for p in ("lo", "hi")}
    new = mgr.books("act", "bf16")

    def body(x):
        return tuple(ref_ring(x, "r", b, "bf16", chunk=chunk)[1][
            "coded_wire_bits"] for b in (old, new))

    stale, fresh = jax.jit(jax.vmap(body, axis_name="r"))(
        jnp.asarray(shifted))
    assert rec["stale_coded_wire_bits"] == float(np.asarray(stale).sum())
    assert rec["refreshed_coded_wire_bits"] == float(np.asarray(fresh).sum())


# --------------------------------------------------------------- engine
def test_engine_hot_refresh_equals_reference():
    """Engine(lifecycle=) on the reduced gemma2-2b (float32, so both
    packages' greedy tokens are robust): the same tokens and refreshes
    as the reference's engine with the same books and thresholds; the
    port's wire stays lossless across the flips (bitexact), with a
    coded KV cache too, and the tokens equal an engine without books."""
    tcfg = get_config("gemma2-2b").reduced(dtype=torch.float32)
    rcfg = ref_get_config("gemma2-2b").reduced(dtype=jnp.float32)
    gen = torch.Generator().manual_seed(0)
    tparams = model_init(tcfg, gen, device="cpu")
    np_params = tree_map(lambda t: t.numpy(), tparams)
    rparams = jax.tree.map(jnp.asarray, np_params)
    prompt = np.random.default_rng(1).integers(0, 512, size=(2, 8)).astype(
        np.int32)
    th = dict(kl_bits=0.0, excess_bits=0.0, min_symbols=1, patience=1)
    new_tokens, every = 4, 2

    def managers():
        rm, tm = RefManager(thresholds=RefThresholds(**th)), \
            BookLifecycleManager(thresholds=DriftThresholds(**th))
        for plane, seed in (("lo", 30), ("hi", 31)):
            for m in (rm, tm):
                m.install(("act", "bf16", plane), _hist(seed))
        return rm, tm

    rm, tm = managers()
    rspec = rm.spec("act", "bf16", mode="ledger")
    reng = RefEngine(rparams, rcfg, RefServe(max_cache_len=16), rspec,
                     lifecycle=rm, refresh_every=every)
    rtoks, rtot = reng.generate(jnp.asarray(prompt), new_tokens)
    teng = Engine(from_jax_params(np_params, tcfg, device="cpu"), tcfg,
                  ServeConfig(max_cache_len=16),
                  tm.spec("act", "bf16", mode="ledger"), lifecycle=tm,
                  refresh_every=every, device="cpu")
    ttoks, ttot = teng.generate(prompt, new_tokens)
    np.testing.assert_array_equal(ttoks, np.asarray(rtoks))
    assert ttot["book_refreshes"] == rtot["book_refreshes"] == 1.0
    assert tm.book_epoch == rm.book_epoch == 3
    assert tm.n_recompiles == rm.n_recompiles == 2
    assert ttot["book_epoch"] == rtot["book_epoch"]

    # the port's bitexact wire and coded KV cache across the flip
    _, tm2 = managers()
    spec = tm2.spec("act", "bf16", mode="bitexact", transport="chunked",
                    chunk=256)
    eng = Engine(tparams, tcfg, ServeConfig(max_cache_len=16), spec,
                 lifecycle=tm2, refresh_every=every, kv_mode="coded",
                 device="cpu")
    toks, tot = eng.generate(prompt, new_tokens)
    np.testing.assert_array_equal(toks, ttoks)
    assert tot["book_refreshes"] == 1.0 and tot["act_decode_mismatch"] == 0
    epochs = [m["book_epoch"] for m in eng.step_metrics]
    assert epochs == [2.0, 2.0, 3.0]
    assert sorted(eng.epoch_specs) == [2, 3]
    for m in eng.step_metrics:
        assert m["act_decoded_bits"] == m["act_coded_bits"] > 0
        in_force = eng.epoch_specs[int(m["book_epoch"])]
        want = sum(int((m[f"act_hist_{p}"].astype(np.int64)
                        * in_force.lengths_for(p)).sum())
                   for p in ("lo", "hi"))
        assert m["act_coded_bits"] == float(want)
    plain = Engine(tparams, tcfg, ServeConfig(max_cache_len=16),
                   device="cpu")
    np.testing.assert_array_equal(plain.generate(prompt, new_tokens)[0],
                                  toks)
