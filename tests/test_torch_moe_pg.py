"""The expert-sharded and a2a MoE on a process-group mesh: a gloo world
of 4 processes, ``{"data": 2, "model": 2}`` (``launch.mesh.device_mesh``
on the CPU, ``comm.process_group_mesh``), started once a module, against
the loopback mesh of the same sizes in this process.

Each process holds its own rows, as under the reference's
``shard_map``: for ``moe_apply_eshard`` its data shard's (replicated
over "model"), for ``moe_apply_a2a_block`` its slice of the batch split
over every axis ("model" minor), and for ``forward_train`` the same
under ``use_mesh`` for each ``moe_impl``.  A process routes its own
rows, where the loopback routes every rank's rows in one product, so
the inputs are checked to have float64 routing margins far above
float32 rounding and the kept and dropped slots are held equal.
Outputs are held within ``chip_smoke.py``'s ``ESHARD_TOL`` (2^-5 of
max |y|) for eshard and the a2a gloo test's 1e-2 for a2a, the coded
bits equal, the losses (their mean over the processes: every shard has
the same tokens) within ``STEP_TOL``, and the gradients, by
``models/moe.py``'s convention (the processes' mean over the axes that
split the rows), within ``GRAD_TOL`` of each leaf's norm.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.comm import LoopbackAxis, loopback_mesh  # noqa: E402
from repro_torch.comm.axis import ProcessGroupAxis  # noqa: E402
from repro_torch.models import BlockGroup, ModelConfig, model_init  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

torch.set_num_threads(1)

SIZES = {"data": 2, "model": 2}
MOE = dict(name="m", arch_type="moe", blocks=(), d_model=64,
           vocab_size=128, n_experts=4, experts_per_token=2, moe_d_ff=64,
           n_shared_experts=1, capacity_factor=1.0, dtype=torch.bfloat16)
# the aux weight is large enough that the aux's part of the router's
# gradient is not lost under the cross-entropy's
TRAIN = dict(name="p", arch_type="moe", blocks=(BlockGroup(("attn_moe",), 2),),
             d_model=64, vocab_size=128, n_heads=4, n_kv_heads=2,
             head_dim=16, n_experts=4, experts_per_token=2, moe_d_ff=64,
             n_shared_experts=1, router_aux_weight=0.1, remat="none",
             dtype=torch.bfloat16)
ESHARD_TOL = 2.0 ** -5
A2A_TOL = 1e-2
GRAD_TOL = 2e-2

_WORKER = r"""
import sys
from dataclasses import replace
import torch
import torch.distributed as dist
from repro_torch.comm import process_group_mesh
from repro_torch.launch.mesh import MeshShape, device_mesh
from repro_torch.models import moe
from repro_torch.train import step as tstep
rank, port, run = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=4, rank=rank)
mesh = process_group_mesh(device_mesh(MeshShape(("data", "model"), (2, 2)),
                                      device_type="cpu"))
dd, mm = mesh["data"].rank, mesh["model"].rank
c = torch.load(run + ".case.pt", weights_only=False)
p, cfg, x = c["params"], c["cfg"], c["x"]
nb = x.shape[0] // 2
xe = x[dd * nb:(dd + 1) * nb]                      # this data shard's rows
out = {"coords": (dd, mm)}
out["eshard"] = moe.moe_apply_eshard(p, xe, cfg, mesh)
nb = x.shape[0] // 4
xa = x[(dd * 2 + mm) * nb:(dd * 2 + mm + 1) * nb]  # "model" minor
out["a2a"] = moe.moe_apply_a2a_block(p, xa, cfg, mesh)
# the slots each path keeps: the process's own routing
topw, topi, _ = moe._route_probs(p, xe.reshape(-1, xe.shape[-1]), cfg)
cap = moe.moe_capacity(xe.shape[0] * xe.shape[1], cfg)
out["eshard_slot"] = moe._dispatch(xe.reshape(1, -1, xe.shape[-1]),
                                   topi.reshape(1, -1, 2), cfg, cap,
                                   thr=cap)[1]
out["a2a_topi"] = moe._route_probs(p, xa.reshape(-1, xa.shape[-1]),
                                   cfg)[1]
for impl, rows in (("eshard", (dd, 2)), ("a2a", (dd * 2 + mm, 4))):
    b = {k: v.chunk(rows[1])[rows[0]] for k, v in c["batch"].items()}
    tcfg = replace(c["train_cfg"], moe_impl=impl)
    with moe.use_mesh(mesh):
        loss, (ce, aux, wire), grads = tstep.loss_and_grads(
            c["train_params"], b, tcfg)
    out[f"train_{impl}"] = (float(loss), float(ce), float(aux.detach()),
                            float(wire), grads)
torch.save(out, f"{run}.{rank}.pt")
dist.destroy_process_group()
"""


def _margin(x, router, k):
    """The least float64 gap between consecutive ranks of a row's top
    k+1 router probabilities."""
    lg = x.double().reshape(-1, router.shape[0]).numpy() @ \
        router.double().numpy()
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    return float(np.diff(-top, axis=-1).min())


def _train_cfg():
    return ModelConfig(**TRAIN)


def _loopback(params, x, cfg, tparams, batch, tcfg):
    """The loopback mesh's results on the whole batch (while the
    processes run)."""
    from dataclasses import replace
    mesh = loopback_mesh(SIZES)
    out = {"eshard": moe.moe_apply_eshard(params, x, cfg, mesh)}
    with moe.use_mesh(mesh):
        out["a2a"] = moe.moe_apply_a2a_block(params, x, cfg)
        for impl in ("eshard", "a2a"):
            loss, (ce, aux, wire), grads = tstep.loss_and_grads(
                tparams, batch, replace(tcfg, moe_impl=impl))
            out[f"train_{impl}"] = (float(loss), float(ce),
                                    float(aux.detach()), float(wire), grads)
    out["topi"] = moe._route_probs(params, x.reshape(-1, 64), cfg)[1]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The case, and the 4 running gloo processes working on it."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    cfg = ModelConfig(**MOE)
    params = moe.moe_init(cfg, torch.Generator().manual_seed(11), "cpu")
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=(8, 12, 64)).astype(np.float32)).to(torch.bfloat16)
    tcfg = _train_cfg()
    tparams = model_init(tcfg, torch.Generator().manual_seed(13),
                         device="cpu")
    tok = torch.from_numpy(np.random.default_rng(14).integers(
        0, 128, (8, 16)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    run = tmp_path_factory.mktemp("pgmesh") / "run"
    torch.save({"params": params, "cfg": cfg, "x": x, "train_cfg": tcfg,
                "train_params": tparams, "batch": batch}, f"{run}.case.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r),
                               str(port), str(run)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    try:
        yield {"procs": procs, "run": run, "params": params, "cfg": cfg,
               "x": x, "done": None,
               "loopback": _loopback(params, x, cfg, tparams, batch, tcfg)}
    finally:
        for p in procs:
            p.kill()
            p.wait()


def _results(w):
    """The 4 processes' results (waits for them once)."""
    if w["done"] is None:
        logs = [p.communicate(timeout=120)[0] for p in w["procs"]]
        assert all(p.returncode == 0 for p in w["procs"]), logs
        w["done"] = [torch.load(f"{w['run']}.{r}.pt", weights_only=False)
                     for r in range(4)]
    return w["done"]


def test_eshard_on_a_process_group_equals_loopback(world):
    """Each process's eshard output is its data shard's rows of the
    loopback mesh's, within ESHARD_TOL; the same slots kept and dropped;
    the aux equal on every process and to the loopback's."""
    p, cfg, x = world["params"], world["cfg"], world["x"]
    assert _margin(x, p["router"], 2) > 1e-5
    y, aux = world["loopback"]["eshard"]
    topi = world["loopback"]["topi"].reshape(2, -1, 2)
    cap = moe.moe_capacity(4 * 12, cfg)
    dropped = 0
    for r, out in enumerate(_results(world)):
        dd, mm = out["coords"]
        assert (dd, mm) == (r // 2, r % 2)          # row-major ranks
        yp, auxp = out["eshard"]
        want = y[dd * 4:(dd + 1) * 4].float()
        err = float((yp.float() - want).abs().max())
        assert err <= ESHARD_TOL * float(want.abs().max()), (r, err)
        assert float(auxp) == pytest.approx(float(aux), rel=1e-5)
        slot = moe._dispatch(x[dd * 4:(dd + 1) * 4].reshape(1, -1, 64),
                             topi[dd][None], cfg, cap, thr=cap)[1]
        assert torch.equal(out["eshard_slot"], slot), r
        dropped += int((slot == 4 * cap).sum())
    assert dropped > 0                               # capacity bites


def test_a2a_block_on_a_process_group_equals_loopback(world):
    """Each process's a2a block output is its slice of the loopback's
    within 1e-2, its routing the loopback's, and the coded bits (the
    whole mesh's dispatch and combine) equal on every process and to the
    loopback's."""
    y, aux, coded = world["loopback"]["a2a"]
    topi = world["loopback"]["topi"].reshape(4, -1, 2)
    for r, out in enumerate(_results(world)):
        yp, auxp, codedp = out["a2a"]
        np.testing.assert_allclose(yp.float().numpy(),
                                   y[2 * r:2 * r + 2].float().numpy(),
                                   rtol=A2A_TOL, atol=A2A_TOL)
        assert torch.equal(out["a2a_topi"], topi[r]), r
        assert float(codedp) == float(coded) > 0
        assert float(auxp) == pytest.approx(float(aux), rel=1e-5)


@pytest.mark.parametrize("impl", ["eshard", "a2a"])
def test_forward_train_on_a_process_group_within_step_tol(world, impl):
    """A 2-layer ``attn_moe`` model under ``use_mesh`` of the process
    group: the mean of the processes' losses within ``STEP_TOL`` of the
    loopback mesh's loss on the whole batch, the aux equal; a2a's coded
    bits equal the loopback's."""
    loss, ce, aux, wire, _ = world["loopback"][f"train_{impl}"]
    got = [out[f"train_{impl}"] for out in _results(world)]
    mean = {"loss": float(np.mean([g[0] for g in got])),
            "ce": float(np.mean([g[1] for g in got]))}
    dev = tstep.step_deviation(mean, {"loss": loss, "ce": ce})
    assert dev["loss"] <= tstep.STEP_TOL["loss"], dev
    for g in got:
        assert g[2] == pytest.approx(aux, rel=1e-5)
        assert g[3] == wire
    assert (wire > 0) == (impl == "a2a")


def _named(tree, pre=""):
    """{path: leaf} of a params tree."""
    if isinstance(tree, dict):
        items = [(f"{pre}/{k}", v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"{pre}/{i}", v) for i, v in enumerate(tree)]
    else:
        return {pre: tree}
    return {p: leaf for q, v in items for p, leaf in _named(v, q).items()}


def _expert(path):
    """A routed expert leaf: (layers, E, ...), split over "model"."""
    return "/ffn/w_" in path


def _rel(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("impl", ["eshard", "a2a"])
def test_forward_train_gradients_on_a_process_group(world, impl):
    """The mean of the processes' gradients over the axes that split the
    rows (``moe.py``'s convention: the data axes under eshard, every axis
    under a2a) is the loopback mesh's gradient on the whole batch,
    within ``GRAD_TOL`` of each leaf's norm: embedding, attention,
    router, shared expert, and each "model" rank's own experts.  Under
    eshard the "model" ranks of a data shard hold the same gradient of
    every replicated leaf, bit for bit, and zero outside their own
    experts.  A rank's missing part of a replicated leaf, or an aux
    weighted by 1/ranks, is far outside ``GRAD_TOL``."""
    want = _named(world["loopback"][f"train_{impl}"][4])
    got = {out["coords"]: _named(out[f"train_{impl}"][4])
           for out in _results(world)}
    e_local = TRAIN["n_experts"] // SIZES["model"]
    errs = {}
    for path, w in want.items():
        if impl == "a2a":
            mean = torch.stack([g[path].double()
                                for g in got.values()]).mean(0)
            errs[path] = _rel(mean, w)
            continue
        for m in range(SIZES["model"]):
            mean = torch.stack([got[dd, m][path].double()
                                for dd in range(SIZES["data"])]).mean(0)
            if not _expert(path):
                errs[path, m] = _rel(mean, w)
                assert all(torch.equal(got[dd, m][path], got[dd, 0][path])
                           for dd in range(SIZES["data"])), (path, m)
                continue
            mine = slice(m * e_local, (m + 1) * e_local)
            errs[path, m] = _rel(mean[:, mine], w[:, mine])
            mean[:, mine] = 0
            assert not mean.any(), (path, m)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_mixed_mesh_raises():
    group = object.__new__(ProcessGroupAxis)          # no world needed
    mesh = {"data": LoopbackAxis(2, name="data"), "model": group}
    cfg = ModelConfig(**MOE)
    x = torch.zeros((4, 2, 64), dtype=torch.bfloat16)
    for fn in (moe.moe_apply_eshard, moe.moe_apply_a2a_block):
        with pytest.raises(NotImplementedError, match="mixes"):
            fn({}, x, cfg, mesh)
