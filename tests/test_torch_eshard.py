"""Port parity, the expert-sharded MoE: ``repro_torch.models.moe
.moe_apply_eshard`` (``moe_impl="eshard"``) against the reference's
``moe_apply_eshard`` on the CPU.

The reference runs its ``shard_map`` on a one-device ``("data",
"model")`` mesh (``jax.set_mesh``; ``Auto`` axes, since under explicit
axes jax 0.9 refuses the sharded output as a ``scan`` carry in the
reference's block stack), jitted; the port runs on loopback
meshes (``comm.loopback_mesh``).  On a 1 × 1 mesh the two are the same
function.  On the port's 2 × 2 mesh each data shard is the reference's
1 × 1 call on that shard: the capacity is the shard's, and the psum over
"model" adds the two ranks' partial outputs, which with top-2 routing
holds at most two nonzero terms a token, added in one rounding either
way.  So it is bit for bit where the expert products are exact in both
frameworks (signed-permutation experts on inputs in {-1, 0, 1}, as in
``tests/test_torch_moe.py``) and at float32 tolerance otherwise.  Routing is held equal on inputs
whose float64 top-k margins are far above float32 rounding.
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import forward_train as ref_forward  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.common import ModelConfig as RefConfig  # noqa: E402
from repro.train import step as ref_step  # noqa: E402

from repro_torch.comm import loopback_mesh  # noqa: E402
from repro_torch.comm.axis import ProcessGroupAxis  # noqa: E402
from repro_torch.models import BlockGroup, ModelConfig, model_init  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.convert import (from_jax_params,  # noqa: E402
                                        tensor_from_numpy)
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
MOE = dict(d_model=64, vocab_size=128, n_experts=4, experts_per_token=2,
           moe_d_ff=64)
MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.detach().numpy()


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _cfgs(dtype="float32", **kw):
    rcfg = RefConfig(name="m", arch_type="moe", blocks=(),
                     dtype=getattr(jnp, dtype), **kw)
    tcfg = ModelConfig(name="m", arch_type="moe", blocks=(),
                       dtype=getattr(torch, dtype), **kw)
    return rcfg, tcfg


def _moe_params(tcfg, seed):
    gen = torch.Generator().manual_seed(seed)
    np_p = tree_map(_np, moe.moe_init(tcfg, gen, "cpu"))
    return np_p, tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_p)


def _exact_params(rng, d, e, ff):
    """Experts whose products are exact in any summation order (signed
    permutations; on inputs in {-1, 0, 1} every product has one nonzero
    term and the gate sees {-1, 0, 1})."""
    def perm(rows, cols, scale):
        w = np.zeros((e, rows, cols), np.float32)
        for i in range(e):
            w[i, rng.permutation(rows)[:cols], np.arange(cols)] = (
                rng.choice([-1.0, 1.0], cols) * scale)
        return w.astype(ml_dtypes.bfloat16)

    return {"router": (rng.normal(size=(d, e)) * d ** -0.5
                       ).astype(np.float32),
            "w_gate": perm(d, ff, 1.0), "w_up": perm(d, ff, 2.0),
            "w_down": perm(ff, d, 0.5)}


def _margin(x, router, k):
    """The least float64 gap between consecutive ranks of a row's top
    k+1 router probabilities."""
    lg = np.asarray(x, np.float64).reshape(-1, router.shape[0]) @ router
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    return float(np.diff(-top, axis=-1).min())


_ref_eshard = {}


def _ref(np_p, x, rcfg):
    """The reference's ``moe_apply_eshard`` on the 1 × 1 mesh, jitted
    once a config."""
    if rcfg not in _ref_eshard:
        _ref_eshard[rcfg] = jax.jit(
            lambda p, xs: ref_moe.moe_apply_eshard(p, xs, rcfg))
    with jax.set_mesh(MESH):
        y, aux = _ref_eshard[rcfg](jax.tree.map(jnp.asarray, np_p),
                                   jnp.asarray(x))
    return np.asarray(y), float(aux)


def test_without_a_model_axis_it_is_moe_apply():
    _, tcfg = _cfgs(**MOE, n_shared_experts=1)
    _, tp = _moe_params(tcfg, 0)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 8, 64)).astype(np.float32))
    want, waux = moe.moe_apply(tp, x, tcfg)
    for mesh in (None, loopback_mesh({"data": 2})):
        with moe.use_mesh(mesh):
            y, aux = moe.moe_apply_eshard(tp, x, tcfg)
        assert torch.equal(y, want) and float(aux) == float(waux)


def test_one_device_mesh_equals_reference():
    """On a 1 × 1 mesh the port is the reference's eshard path: y and
    aux at float32 tolerance, and not ``moe_apply`` (the batch-global
    capacity drops other slots than the streaming one)."""
    rcfg, tcfg = _cfgs(**MOE, n_shared_experts=1, capacity_factor=1.0)
    np_p, tp = _moe_params(tcfg, 2)
    x = np.random.default_rng(3).normal(size=(2, 16, 64)).astype(np.float32)
    assert _margin(x, np_p["router"], 2) > 1e-5
    want, waux = _ref(np_p, x, rcfg)
    xt = torch.from_numpy(x)
    y, aux = moe.moe_apply_eshard(tp, xt, tcfg,
                                  loopback_mesh({"data": 1, "model": 1}))
    np.testing.assert_allclose(y.numpy(), want, **F32)
    assert float(aux) == pytest.approx(waux, rel=1e-5)
    y_sc, _ = moe.moe_apply(tp, xt, tcfg)
    assert float((y - y_sc).abs().max()) > 0.1
    cap = moe.moe_capacity(32, tcfg)
    _, topi, _ = moe._route(tp, xt.reshape(-1, 64), tcfg)
    _, slot, _ = moe._dispatch(xt.reshape(1, 32, 64),
                               topi.reshape(1, 32, 2), tcfg, cap, thr=cap)
    assert int((slot == 4 * cap).sum()) > 0          # slots were dropped


@pytest.mark.parametrize("weights", ["exact", "random"])
@pytest.mark.parametrize("sizes", [{"data": 2, "model": 2},
                                   {"model": 2, "data": 2}])
def test_each_data_shard_equals_the_reference_on_that_shard(weights, sizes):
    """A loopback data × model mesh of 2 × 2 (either dim order): each
    data shard's output is the reference's 1 × 1 call on that shard, bit
    for bit on exact products (bf16), at float32 tolerance otherwise;
    the aux loss is the mean of the shards' (pmean over model, then
    data)."""
    rng = np.random.default_rng(7)
    if weights == "exact":
        rcfg, tcfg = _cfgs("bfloat16", **MOE, capacity_factor=1.0)
        np_p = _exact_params(rng, 64, 4, 64)
        x = rng.integers(-1, 2, (4, 12, 64)).astype(ml_dtypes.bfloat16)
        tp = tree_map(lambda a: tensor_from_numpy(a, "cpu"), np_p)
    else:
        rcfg, tcfg = _cfgs(**MOE, n_shared_experts=1, capacity_factor=1.0)
        np_p, tp = _moe_params(tcfg, 4)
        x = rng.normal(size=(4, 12, 64)).astype(np.float32)
    assert _margin(x, np_p["router"], 2) > 1e-5
    y, aux = moe.moe_apply_eshard(tp, tensor_from_numpy(x, "cpu"), tcfg,
                                  loopback_mesh(sizes))
    auxes = []
    for i in range(2):
        want, waux = _ref(np_p, x[2 * i:2 * i + 2], rcfg)
        got = y[2 * i:2 * i + 2]
        if weights == "exact":
            assert torch.equal(_bits(got), _bits(tensor_from_numpy(
                want, "cpu")))
        else:
            np.testing.assert_allclose(got.numpy(), want, **F32)
        auxes.append(waux)
    assert float(aux) == pytest.approx(np.mean(auxes), rel=1e-5)


def test_refusals():
    _, tcfg = _cfgs(**dict(MOE, n_experts=3))
    _, tp = _moe_params(tcfg, 0)
    x = torch.zeros((4, 2, 64))
    with pytest.raises(ValueError, match="not divisible by axis 'model'"):
        moe.moe_apply_eshard(tp, x, tcfg, loopback_mesh({"model": 2}))
    _, tcfg = _cfgs(**MOE)
    _, tp = _moe_params(tcfg, 0)
    with pytest.raises(ValueError, match="batch 4 not divisible"):
        moe.moe_apply_eshard(tp, x, tcfg, loopback_mesh({"data": 3,
                                                         "model": 1}))
    group = object.__new__(ProcessGroupAxis)          # no world needed
    with pytest.raises(NotImplementedError, match="process-group"):
        moe.moe_apply_eshard(tp, x, tcfg, {"data": loopback_mesh(
            {"data": 2})["data"], "model": group})


def test_forward_train_with_eshard_within_step_tol():
    """``forward_train`` with ``moe_impl="eshard"`` on a 1 × 1 mesh
    against the reference's under its 1 × 1 mesh (float32, one MLA + MoE
    layer): loss and every gradient within ``STEP_TOL``; on a 2 × 2
    loopback mesh the step runs and its gradients are finite."""
    kw = dict(d_model=64, vocab_size=128, n_heads=2, n_kv_heads=2,
              head_dim=32, q_lora_rank=32, kv_lora_rank=16,
              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
              n_experts=4, experts_per_token=2, moe_d_ff=64,
              n_shared_experts=1, remat="none", moe_impl="eshard")
    blocks = (BlockGroup(("mla_moe",), 1),)
    rcfg = RefConfig(name="e", arch_type="moe", blocks=blocks,
                     dtype=jnp.float32, **kw)
    tcfg = ModelConfig(name="e", arch_type="moe", blocks=blocks,
                       dtype=torch.float32, **kw)
    np_params = tree_map(_np, model_init(
        tcfg, torch.Generator().manual_seed(5), device="cpu"))
    tok = np.random.default_rng(6).integers(0, 128, (4, 16))
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}

    def ref_loss(p, b):
        logits, aux = ref_forward(p, b, rcfg)
        return ref_step.cross_entropy_loss(logits, b["labels"]) + aux

    with jax.set_mesh(MESH):
        rl, rg = jax.jit(jax.value_and_grad(ref_loss))(
            jax.tree.map(jnp.asarray, np_params),
            {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()})
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with moe.use_mesh(loopback_mesh({"data": 1, "model": 1})):
        loss, _, grads = tstep.loss_and_grads(tparams, tb, tcfg)
    dev = tstep.step_deviation({"loss": loss, "grads": grads},
                               {"loss": float(rl),
                                "grads": jax.device_get(rg)})
    assert all(v <= tstep.STEP_TOL[k] for k, v in dev.items()), dev
    with moe.use_mesh(loopback_mesh({"data": 2, "model": 2})):
        loss2, _, grads2 = tstep.loss_and_grads(tparams, tb, tcfg)
    assert bool(torch.isfinite(loss2)) and all(
        bool(torch.isfinite(g).all()) for g in tree_leaves(grads2))
    with moe.use_mesh(loopback_mesh({"data": 2, "model": 2})):
        loss_sc, _, _ = tstep.loss_and_grads(
            tparams, tb, replace(tcfg, moe_impl="scatter"))
    assert float(loss_sc) != float(loss2)     # eshard ran, not scatter
