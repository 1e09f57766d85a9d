"""Port parity, prefix embeddings: ``internvl2-26b`` (a VLM decoder after a
patch prefix) and ``hubert-xlarge`` (a bidirectional encoder over frame
embeddings) against the JAX reference on the CPU, at ``reduced()`` size.

Weights are drawn once by the port's ``model_init``, handed to the
reference as numpy arrays and to the port through
``models.convert.from_jax_params`` (so the converter carries both
trees: hubert's unused token table and untied head, internvl's untied
head).  Prefix embeddings and batches are the reference's
``SyntheticDataset`` draws.  The reference's prefill, decode, engine
and train step (with its gradient) are jitted once each; the rest runs
eagerly.

Tolerances: forward, prefill and decode logits in float32 within
rtol/atol 1e-4 (the two frameworks add in other orders); greedy tokens
equal; batches bit for bit; a compressed bf16 train step within
``train.step.STEP_TOL``, with the gradient probe's bits and histograms
equal on the same gradients.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import (DataConfig as RefData,  # noqa: E402
                        SyntheticDataset as RefDataset,
                        batch_spec as ref_batch_spec)
from repro.launch.train import (  # noqa: E402
    bootstrap_codebooks as ref_bootstrap)
from repro.lifecycle import BookLifecycleManager as RefManager  # noqa: E402
from repro.models import (decode_step as ref_decode,  # noqa: E402
                          forward_train as ref_forward,
                          model_init as ref_init, prefill as ref_prefill)
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.serve.engine import (Engine as RefEngine,  # noqa: E402
                                ServeConfig as RefServe)
from repro.train import step as ref_step  # noqa: E402

from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticDataset,  # noqa: E402
                              batch_spec)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.lifecycle import BookLifecycleManager  # noqa: E402
from repro_torch.models import (decode_step, forward,  # noqa: E402
                                forward_train, model_init, param_count,
                                prefill)
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_jax_params, tensor_from_numpy)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

# The reference's prefill and decode, jitted once each.
ref_prefill = jax.jit(ref_prefill, static_argnums=(2, 3))
ref_decode = jax.jit(ref_decode, static_argnums=4)

ARCHS = ("internvl2-26b", "hubert-xlarge")
TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3
# the reference's model_init (jax.eval_shape) and the configs' sources
PARAMS = {"internvl2-26b": 19_861_260_288, "hubert-xlarge": 1_259_705_600}


def _np(t):
    """A torch tensor as numpy, bf16 as ml_dtypes' bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def _cfgs(arch, f32):
    """(reference, port) reduced configs, float32 or the configs' bf16."""
    rcfg, tcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    if f32:
        rcfg = dataclasses.replace(rcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return rcfg, tcfg


@functools.lru_cache(maxsize=None)
def _pair(arch, f32=True):
    """(reference cfg, port cfg, reference params, port params): one draw
    of the port's ``model_init``, the reference's as jnp arrays, the
    port's through ``from_jax_params``."""
    rcfg, tcfg = _cfgs(arch, f32)
    np_params = tree_map(_np, model_init(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    rparams = jax.tree.map(jnp.asarray, np_params)
    return rcfg, tcfg, rparams, from_jax_params(np_params, tcfg, device="cpu")


def _batch(rcfg, b=2, s=8, seed=0):
    return next(RefDataset(rcfg, RefData(b, s, seed=seed)))


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------- configs, params
@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_trees_equal_reference(arch):
    """At full width the port's tree (on the meta device) has the
    reference's leaves, shapes and dtypes: 19.861 B parameters for
    internvl2-26b (39.72 GB in bf16), 1.2597 B for hubert-xlarge."""
    want = jax.eval_shape(lambda k: ref_init(ref_get_config(arch), k),
                          jax.random.PRNGKey(0))
    got = model_init(get_config(arch), torch.Generator(), device="meta")
    rl, tl = jax.tree.leaves(want), tree_leaves(got)
    assert [tuple(a.shape) for a in rl] == [tuple(t.shape) for t in tl]
    assert [jnp.dtype(a.dtype).name for a in rl] == [
        str(t.dtype).split(".")[-1] for t in tl]
    assert param_count(got) == sum(a.size for a in rl) == PARAMS[arch]
    assert set(got["embed"]) == {"table", "head"}          # untied


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_equal_reference(arch):
    rcfg, tcfg = _cfgs(arch, False)
    for seed in (0, 5):
        assert batch_spec(tcfg, DataConfig(3, 8, seed=seed)) == \
            ref_batch_spec(rcfg, RefData(3, 8, seed=seed))
        ds = SyntheticDataset(tcfg, DataConfig(3, 8, seed=seed))
        want_ds = RefDataset(rcfg, RefData(3, 8, seed=seed))
        for _ in range(2):
            got, want = next(ds), next(want_ds)
            assert list(got) == list(want)
            assert ("tokens" in got) != tcfg.prefix_only
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k])


# ----------------------------------------------------- forward, serve
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_equals_reference(arch):
    """internvl: [16 patches] + 8 tokens → logits over the 8 tokens;
    hubert: 8 frames, bidirectional, → logits over every frame."""
    rcfg, tcfg, rparams, tparams = _pair(arch)
    batch = _batch(rcfg)
    want, _ = ref_forward(rparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, rcfg)
    got, aux = forward_train(tparams, _torch(batch), tcfg)
    assert got.shape == want.shape == (2, 8, tcfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(forward(tparams, _torch(batch), tcfg).numpy(),
                               got.detach().numpy(), rtol=0, atol=0)
    if tcfg.prefix_only:         # the encoder sees later frames
        head = {k: v[:, :4] for k, v in _torch(batch).items()}
        part = forward(tparams, head, tcfg)
        assert not torch.allclose(part, got[:, :4].detach(), **TOL)


def test_prefill_and_decode_after_prefix_equal_reference():
    rcfg, tcfg, rparams, tparams = _pair("internvl2-26b")
    batch = _batch(rcfg, s=10, seed=1)
    pfx, tok = batch["prefix_embeds"], batch["tokens"]
    n_pfx = pfx.shape[1]
    head = {"tokens": tok[:, :6], "prefix_embeds": pfx}
    want, rc = ref_prefill(rparams, {k: jnp.asarray(v)
                                     for k, v in head.items()}, rcfg, 32)
    got, tc = prefill(tparams, _torch(head), tcfg, 32)
    assert got.shape == (2, 6, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = forward(tparams, _torch({"tokens": tok, "prefix_embeds": pfx}),
                   tcfg)
    for t in range(6, 10):
        step = tok[:, t:t + 1]
        want, rc = ref_decode(rparams, jnp.asarray(step), rc,
                              jnp.int32(n_pfx + t), rcfg)
        got, tc = decode_step(tparams, torch.from_numpy(step).long(), tc,
                              n_pfx + t, tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   **TOL)


def test_generate_with_prefix_embeds_equals_reference():
    """Greedy tokens after a 16-patch prefix equal the reference engine's
    (float32); in bf16 the coded KV engine ingests the prefix's slots
    with the prompt's and serves the raw engine's tokens."""
    rcfg, tcfg, rparams, tparams = _pair("internvl2-26b")
    batch = _batch(rcfg, s=6, seed=2)
    tok, pfx = batch["tokens"], batch["prefix_embeds"]
    want, _ = RefEngine(rparams, rcfg, RefServe(max_cache_len=40)).generate(
        jnp.asarray(tok), 6, prefix_embeds=jnp.asarray(pfx))
    got, _ = Engine(tparams, tcfg, ServeConfig(max_cache_len=40),
                    device="cpu").generate(tok, 6, prefix_embeds=pfx)
    np.testing.assert_array_equal(got, np.asarray(want))

    _, bcfg, _, bparams = _pair("internvl2-26b", f32=False)
    sc = ServeConfig(max_cache_len=40)
    raw, _ = Engine(bparams, bcfg, sc, device="cpu").generate(
        tok, 6, prefix_embeds=pfx)
    logits, _ = prefill(bparams, _torch(batch), bcfg, 40)
    u16 = logits.to(torch.bfloat16).view(torch.int16).reshape(-1).numpy()
    u16 = u16.view(np.uint16)
    books = {"lo": build_codebook(np.bincount(u16 & 0xFF, minlength=256)),
             "hi": build_codebook(np.bincount(u16 >> 8, minlength=256))}
    spec = CompressionSpec.from_books(books, "bf16", chunk=64)
    eng = Engine(bparams, bcfg, sc, spec, kv_mode="coded", device="cpu")
    coded, totals = eng.generate(tok, 6, prefix_embeds=pfx)
    np.testing.assert_array_equal(coded, raw)
    (first, *rest), = eng._kv._segments.values()
    assert first.slots.tolist() == list(range(pfx.shape[1] + tok.shape[1]))
    assert [s.slots.numel() for s in rest] == [1] * 5
    assert 0 < totals["kv_hbm_coded_bits"] < totals["kv_hbm_raw_bits"]


# ------------------------------------------------------------- training
def test_compressed_hubert_train_step_equals_reference():
    """A compressed reduced hubert-xlarge step (bf16, books from the
    bootstrap sample) within STEP_TOL of the reference's; the probe of
    the reference's gradients (the token table's zeros included) equal
    to the reference's, bits and histograms; grad_accum 2 within STEP_TOL
    of 1 on the port."""
    rcfg, tcfg, rparams, tparams = _pair("hubert-xlarge", f32=False)
    batch = _batch(rcfg, b=4, s=16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rstate = ref_step.train_state_init(rparams)
    mgr = RefManager()
    ref_bootstrap(rstate, mgr)
    rspec = mgr.spec("grad", "bf16", mode="ledger")
    rstep = ref_step.make_train_step(rcfg, ref_adamw.AdamWConfig(lr=LR),
                                     comp_spec=rspec)

    def loss(p, b):
        logits, aux = ref_forward(p, b, rcfg)
        return ref_step.cross_entropy_loss(logits, b["labels"]) + aux

    def step_and_probe(st, b):          # one compile for both
        g = jax.grad(loss)(st.params, b)
        return rstep(st, b), g, ref_step.grad_payload_stats(g, rspec)

    (rnew, rm), rgrads, rprobe = jax.device_get(
        jax.jit(step_and_probe)(rstate, jb))
    assert not np.asarray(rgrads["embed"]["table"]).any()

    tm = BookLifecycleManager()
    state = tstep.train_state_init(tparams)
    launch_train.bootstrap_codebooks(state, tm)
    tspec = tm.spec("grad", "bf16", mode="ledger")
    assert tspec.plane_lengths == rspec.plane_lengths
    step = tstep.make_train_step(tcfg, adamw.AdamWConfig(lr=LR),
                                 comp_spec=tspec)
    new, m = step(state, _torch(batch))
    assert set(m) == set(rm)
    keys = ("loss", "ce", "grad_norm")
    dev = tstep.step_deviation(
        {**{k: m[k] for k in keys}, "m": new.opt.m, "params": new.params},
        {**{k: rm[k] for k in keys}, "m": rnew.opt.m,
         "params": rnew.params}, LR)
    print("step_deviation", dev)
    assert all(v <= tstep.STEP_TOL[k] for k, v in dev.items()), dev
    assert float(m["grad_raw_bits"]) == float(rm["grad_raw_bits"]) == \
        16 * param_count(tparams)
    assert float(m["moe_wire_raw_bits"]) == float(rm["moe_wire_raw_bits"]) == 0
    probe = tstep.grad_payload_stats(
        jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"),
                     rgrads), tspec)
    for k in ("raw_bits", "coded_bits"):
        assert float(probe[k]) == float(rprobe[k]) > 0, k
    for p in ("lo", "hi"):
        np.testing.assert_array_equal(probe[f"hist_{p}"].numpy(),
                                      np.asarray(rprobe[f"hist_{p}"]))
    np.testing.assert_allclose(float(probe["shannon_bits"]),
                               float(rprobe["shannon_bits"]), rtol=1e-6)

    l1, _, g1 = tstep.loss_and_grads(tparams, _torch(batch), tcfg)
    l2, _, g2 = tstep.loss_and_grads(tparams, _torch(batch), tcfg,
                                     grad_accum=2)
    dev2 = tstep.step_deviation({"loss": l2, "grads": g2},
                                {"loss": l1, "grads": g1})
    assert all(v <= tstep.STEP_TOL[k] for k, v in dev2.items()), dev2



@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_main_trains_prefix_models(arch, capsys):
    """``--arch internvl2-26b`` / ``hubert-xlarge`` train (reduced, on the
    CPU) with the gradient probe, and the bootstrap books refresh."""
    rec = launch_train.main(["--arch", arch, "--reduced", "--steps", "2",
                             "--batch-size", "2", "--seq-len", "16",
                             "--compress", "--refresh-every", "1",
                             "--device", "cpu"])
    assert f"arch={get_config(arch).reduced().name}" in capsys.readouterr().out
    assert all(np.isfinite(s["loss"]) and s["grad_coded_bits"] > 0
               for s in rec["steps"])
    assert rec["lifecycle"].book_epoch > 2
