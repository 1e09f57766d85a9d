"""Port parity, the hillclimb: ``launch.dryrun.plan_combo``'s
``param_sharding`` (tp | fsdp | dp_only) and ``opt_sharding`` (mirror |
zero1) against the reference's ``lower_combo`` rules, the collective
rules they add against hand counts, ``launch.hillclimb`` against the
reference's ``run_pair``, and ``roofline.perf_log_md`` / ``report_md
.pick_hillclimb`` against the reference's.

The reference's ``launch.hillclimb`` and ``launch.dryrun`` append a
512-device flag to ``XLA_FLAGS`` when imported, so neither is imported
here: the hillclimb's constants, ``_apply_compression`` and ``run_pair``
are compiled from its source (``ast``), ``run_pair`` with its two
imports taken out and a ``lower_combo`` that records its arguments and
returns the port's plan of them.  Under ``dp_only`` the port's analytic
terms count what a device holds, where the reference's keep the
tensor-parallel counts: that difference is pinned, not copied.
"""
import ast
import copy
import math
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, List

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import input_pspecs as ref_input_pspecs  # noqa: E402
from repro.launch.mesh import axes_for as ref_axes_for  # noqa: E402
from repro.models.transformer import model_pspec as ref_model_pspec  # noqa: E402
from repro.roofline import perf_log_md as ref_perf_log_md  # noqa: E402
from repro.roofline import report_md as ref_report_md  # noqa: E402
from repro.roofline.analytic import analytic_terms as ref_analytic_terms  # noqa: E402

from repro_torch.configs import SHAPES, get_config, shape_plan  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch.mesh import H100_SXM, make_production_mesh  # noqa: E402
from repro_torch.models import BlockGroup, ModelConfig  # noqa: E402
from repro_torch.models.common import (Axes, PSpec, pspec_leaves,  # noqa: E402
                                      pspec_map, tree_leaves)
from repro_torch.models.transformer import (fsdp_pspec,  # noqa: E402
                                            model_init, model_pspec)
from repro_torch.optim.adamw import zero1_state_pspec  # noqa: E402
from repro_torch.roofline import perf_log_md, report_md  # noqa: E402
from repro_torch.roofline.collectives import collective_stats  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" \
    / "hillclimb.py"
OPTIONS = [("tp", "mirror"), ("tp", "zero1"), ("fsdp", "mirror"),
           ("fsdp", "zero1"), ("dp_only", "mirror")]
COMBOS = [("mamba2-780m", "train_4k"), ("deepseek-v3-671b", "train_4k"),
          ("qwen3-4b", "prefill_32k"), ("llama4-scout-17b-a16e",
                                        "decode_32k")]


def _reference_hillclimb(lower_combo):
    """The reference's ``launch.hillclimb`` compiled from its source
    without its imports: a namespace with ``RATIO_PAPER``,
    ``RATIO_PLANE_SPLIT``, ``PAIRS``, ``_apply_compression`` and
    ``run_pair`` (which calls the given ``lower_combo``)."""
    tree = ast.parse(SRC.read_text())
    ns: Dict[str, Any] = {"replace": replace, "Dict": Dict, "Any": Any,
                          "List": List, "get_config": get_config,
                          "lower_combo": lower_combo}
    body = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) in (
                "RATIO_PAPER", "RATIO_PLANE_SPLIT", "PAIRS"):
            body.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in (
                "_apply_compression", "run_pair"):
            node.body = [n for n in node.body
                         if not isinstance(n, ast.ImportFrom)]
            body.append(node)
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SRC), "exec"),
         ns)
    return ns


class _Planner:
    """``plan_combo`` with a memo and a log of its calls (arch, shape,
    the config's fields, keyword arguments)."""

    def __init__(self):
        self.memo, self.calls = {}, []
        self.plan = dryrun.plan_combo

    def __call__(self, arch, shape, *, cfg_override, verbose, **kw):
        key = (arch, shape, repr(cfg_override), tuple(sorted(kw.items())))
        self.calls.append(key)
        if key not in self.memo:
            self.memo[key] = self.plan(
                arch, shape, cfg_override=cfg_override, verbose=False, **kw)
        return copy.deepcopy(self.memo[key])


@pytest.fixture(scope="module")
def driven():
    """Every pair through the port's ``run_pair`` and the reference's,
    on one memoised planner, each asking for the same plans: (port
    records, reference records, the reference's namespace)."""
    planner = _Planner()
    ref = _reference_hillclimb(planner)
    ours, theirs = [], []
    real = dryrun.plan_combo
    for pair in hillclimb.PAIRS:
        planner.calls = []
        dryrun.plan_combo = planner          # run_pair imports it late
        try:
            hillclimb.run_pair(pair, ours)
        finally:
            dryrun.plan_combo = real
        port_calls, planner.calls = planner.calls, []
        ref["run_pair"](pair, theirs)
        assert port_calls == planner.calls, pair
    return ours, theirs, ref


def test_run_pair_equals_the_reference_hillclimb(driven):
    """All four pairs: the same plans asked for (arch, shape, config,
    options), and the same records: iteration names, hypotheses, the
    best record picked and the compression arithmetic."""
    ours, theirs, ref = driven
    assert (hillclimb.RATIO_PAPER, hillclimb.RATIO_PLANE_SPLIT,
            hillclimb.PAIRS) == (ref["RATIO_PAPER"], ref["RATIO_PLANE_SPLIT"],
                                 ref["PAIRS"])
    assert [(r["pair"], r["iteration"]) for r in ours] == [
        (r["pair"], r["iteration"]) for r in theirs]
    assert len(ours) == 24
    assert ours == theirs
    rec = ours[0]
    for ratio, label in ((0.822, "a"), (0.5, "b")):
        assert hillclimb._apply_compression(rec, ratio, label) == \
            ref["_apply_compression"](rec, ratio, label)
    # each pair's last two records scale the chosen plan's wire
    for pair in hillclimb.PAIRS:
        rows = [r for r in ours if r["pair"] == pair]
        paper, split = rows[-2], rows[-1]
        assert math.isclose(paper["collective_s"] / split["collective_s"],
                            0.822 / 0.715, rel_tol=1e-12)


def test_main_writes_and_reuses_records(tmp_path, capsys):
    out = tmp_path / "sub" / "hc.json"
    recs = hillclimb.main(["--pair", "mamba2", "--out", str(out)])
    assert [r["iteration"] for r in recs] == [
        "baseline(chunk=128)", "chunk=64", "chunk=256", "dp_only",
        "paper: fixed-codebook wire compression",
        "beyond-paper: plane-split codebooks"]
    again = hillclimb.main(["--pair", "mamba2", "--out", str(out)])
    assert "6 cached records, skipping" in capsys.readouterr().out
    mark = f"[reused from {out}] "
    assert [r["note"] for r in again] == [mark + r["note"] for r in recs]
    assert [dict(r, note=None) for r in again] == [dict(r, note=None)
                                                   for r in recs]
    # a later reuse marks a record once
    assert hillclimb.main(["--pair", "mamba2", "--out", str(out)]) == again


@pytest.fixture(scope="module")
def plans():
    return {(a, s, ps, os_): dryrun.plan_combo(
        a, s, param_sharding=ps, opt_sharding=os_, verbose=False)
        for a, s in COMBOS for ps, os_ in OPTIONS}


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_analytic_terms_equal_reference_where_counts_agree(arch, shape,
                                                           plans):
    """tp, fsdp and zero1: the reference's ``analytic_terms`` with its
    own shard counts (``lower_combo``'s), floats exactly."""
    s = SHAPES[shape]
    rc, _ = shape_plan(get_config(arch), shape)
    for ps, os_ in OPTIONS:
        rec = plans[(arch, shape, ps, os_)]
        if ps == "dp_only":
            continue
        p_shards = 256 if ps == "fsdp" else 16
        want = ref_analytic_terms(
            rc, kind=s.kind, seq_len=s.seq_len, global_batch=s.global_batch,
            n_params=rec["n_params"], n_active_params=rec["n_active_params"],
            n_devices=256, model_shards=16, data_shards=16, hw=H100_SXM,
            cache_bytes_total=_cache_bytes(rc, shape),
            grad_accum=rec["grad_accum"] or 1, param_shards=p_shards,
            opt_shards=256 if os_ == "zero1" else p_shards)
        for k, v in want.items():
            assert rec[k] == v, (ps, os_, k)
        assert (rec["param_sharding"], rec["opt_sharding"]) == (ps, os_)


def _cache_bytes(cfg, shape):
    if SHAPES[shape].kind != "decode":
        return 0.0
    from repro_torch.configs import input_specs
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(
        input_specs(cfg, shape)["caches"])))


def _flat(tree):
    """A spec tree's leaves as tuples, dict keys sorted (jax's order)."""
    if isinstance(tree, P):
        return [tuple(tree)]
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))
    return [tuple(x) for x in leaves]


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_specs_of_each_option(arch, shape):
    """``dp_only``: the reference's rule on the reference's
    ``model_pspec`` and ``input_pspecs`` (params replicated, the batch
    dim on (data, model)); ``fsdp`` and ``zero1`` the port's
    ``fsdp_pspec`` (data degree 16) and ``zero1_state_pspec``."""
    mesh = make_production_mesh()
    cfg, _ = shape_plan(get_config(arch), shape)
    rcfg, _ = shape_plan(ref_get_config(arch), shape)
    params = model_init(cfg, None, device="meta")
    ps, opt, ins = dryrun.plan_pspecs(cfg, shape, mesh, params,
                                      param_sharding="dp_only")
    rax = ref_axes_for(mesh)
    want = jax.tree.map(lambda s: P(*((None,) * len(tuple(s)))),
                        ref_model_pspec(rcfg, rax),
                        is_leaf=lambda x: isinstance(x, P))

    def dp_batch(s):
        parts = tuple(s)
        if parts and parts[0] is not None:
            return P(*((("data", "model"),) + parts[1:]))
        return P(*parts)

    want_in = jax.tree.map(dp_batch, ref_input_pspecs(rcfg, shape, rax),
                           is_leaf=lambda x: isinstance(x, P))
    assert [tuple(s) for s in pspec_leaves(ps)] == _flat(want)
    assert [tuple(s) for s in pspec_leaves(ins)] == _flat(want_in)
    assert (opt is None) == (SHAPES[shape].kind != "train")
    axes = Axes(model_size=16)
    ps, opt, _ = dryrun.plan_pspecs(cfg, shape, mesh, params,
                                    param_sharding="fsdp",
                                    opt_sharding="zero1")
    fsdp = fsdp_pspec(cfg, axes, data_degree=16)
    assert list(map(tuple, pspec_leaves(ps))) == list(
        map(tuple, pspec_leaves(fsdp)))
    if opt is not None:
        z = zero1_state_pspec(fsdp, params, axes)
        assert list(map(tuple, pspec_leaves(opt.m))) == list(
            map(tuple, pspec_leaves(z.m)))
    with pytest.raises(ValueError, match="param_sharding"):
        dryrun.plan_pspecs(cfg, shape, mesh, params, param_sharding="zero3")
    with pytest.raises(ValueError, match="opt_sharding"):
        dryrun.plan_pspecs(cfg, shape, mesh, params, opt_sharding="zero2")


def test_dp_only_is_one_card_and_the_reference_counts_are_pinned(plans):
    """mamba2-780m x train_4k under dp_only: the analytic terms of one
    card's step at 1 x 4096 (``one_card_bound``); the reference's
    tensor-parallel counts (16, 16, 16) give 118.11 GB a device where
    the device holds 41.57 GB of traffic."""
    rec = plans[("mamba2-780m", "train_4k", "dp_only", "mirror")]
    one = dryrun.one_card_bound(get_config("mamba2-780m"), kind="train",
                                seq_len=4096, global_batch=1)
    for k in ("analytic_flops", "analytic_bytes", "analytic_compute_s",
              "analytic_memory_s"):
        assert math.isclose(rec[k], one[k], rel_tol=1e-12), k
    assert one["n_params"] == rec["n_params"] == 779_989_248
    assert round(rec["analytic_bytes"] / 1e9, 2) == 41.57
    assert round(rec["analytic_memory_s"] * 1e3, 2) == 12.41
    assert round(rec["analytic_compute_s"] * 1e3, 2) == 25.84
    ref = ref_analytic_terms(
        ref_get_config("mamba2-780m"), kind="train", seq_len=4096,
        global_batch=256, n_params=rec["n_params"],
        n_active_params=rec["n_active_params"], n_devices=256,
        model_shards=16, data_shards=16, hw=H100_SXM, grad_accum=1,
        param_shards=16, opt_shards=16)
    assert round(ref["analytic_bytes"] / 1e9, 2) == 118.11
    assert round(ref["analytic_memory_s"] * 1e3, 2) == 35.26
    assert ref["analytic_compute_s"] == rec["analytic_compute_s"]
    tp = plans[("mamba2-780m", "train_4k", "tp", "mirror")]
    assert tp["analytic_bytes"] == ref["analytic_bytes"]
    # the device holds every param, gradient and moment
    n = rec["n_params"]
    whole = float(sum(t.numel() * t.element_size() for t in tree_leaves(
        model_init(get_config("mamba2-780m"), None, device="meta"))))
    mem = rec["bytes_per_device"]
    assert (mem["params"], mem["grads"]) == (whole, whole)
    assert mem["optimizer"] == 8.0 * n + 4.0
    assert mem["inputs"] == 2 * 4096 * 4.0


def _one_layer(kind="attn", **kw):
    base = dict(name="t", arch_type="dense", d_model=64, vocab_size=128,
                blocks=(BlockGroup((kind,), 2),), n_heads=8, n_kv_heads=8,
                head_dim=8, d_ff=128, remat="block")
    base.update(kw)
    return ModelConfig(**base)


def test_new_collective_rules_against_hand_counts():
    """On a 2-layer config and a (data 2, model 4) mesh, batch 4 x 8:
    fsdp's per-layer all-gathers and gradient reduce-scatter, zero1's
    reduce-scatter and all-gather, dp_only's one all-reduce over every
    device."""
    sizes = {"data": 2, "model": 4}
    axes = Axes(model_size=4)
    cfg = _one_layer()
    meta = model_init(cfg, None, device="meta")

    def stats(pspec, batch_axes, opt=None, kind="train"):
        return collective_stats(
            cfg, kind=kind, seq_len=8, global_batch=4, sizes=sizes,
            param_pspec=pspec, params=meta, batch_axes=batch_axes,
            opt_pspec=opt)

    tp = model_pspec(cfg, axes)
    # a layer's bytes on a model rank: the 7 bf16 projections over
    # model (4), the two float32 norms whole; the embedding table and
    # head over model, the final norm whole
    layer = (4 * 64 * 64 + 3 * 64 * 128) * 2 / 4 + 2 * 64 * 4
    top = 2 * 128 * 64 * 2 / 4 + 64 * 4
    grad = 2 * layer + top
    act = 2 * 8 * 64 * 2.0                 # T x d x 2 bytes a device
    tp_wire = 2 * 3 * 2 * act * 2 * 3 / 4  # 2 layers x 3 passes x 2 ARs

    st = stats(tp, ("data",))
    assert st.by_rule == {"tp": tp_wire, "dp": grad * 2 * 1 / 2}
    # zero1: every leaf's moments on data (a dim divisible by 16), so a
    # reduce-scatter (shard G/2, factor n-1) and an all-gather (G, (n-1)/n)
    opt = zero1_state_pspec(tp, meta, axes)
    st = stats(tp, ("data",), opt.m)
    assert st.counts == {"all-reduce": 12, "reduce-scatter": 1,
                         "all-gather": 1}
    assert st.payload_bytes["reduce-scatter"] == grad / 2
    assert st.wire_bytes["reduce-scatter"] == grad / 2 * 1
    assert st.wire_bytes["all-gather"] == grad * 1 / 2
    assert st.by_rule["dp"] + st.by_rule["zero1"] == grad   # = the AR's
    # fsdp (data degree 2): each layer gathered three times (forward,
    # re-forward, backward), the embedding and final norm twice; the
    # gradient reduce-scattered over data
    fs = fsdp_pspec(cfg, axes, data_degree=2)
    st = stats(fs, ("data",))
    assert st.counts == {"all-reduce": 12, "all-gather": 2 * 3 + 2,
                         "reduce-scatter": 1}
    assert st.by_rule["fsdp"] == (2 * 3 * layer + 2 * top) * 1 / 2
    assert st.wire_bytes["reduce-scatter"] == grad / 2
    assert "zero1" not in st.by_rule       # zero1 on fsdp adds nothing
    st1 = stats(fs, ("data",), zero1_state_pspec(fs, meta, axes).m)
    assert st1.by_rule == st.by_rule
    # prefill: one gather a layer, the top leaves once; no gradient
    st = stats(fs, ("data",), kind="prefill")
    assert st.by_rule["fsdp"] == (2 * layer + top) * 1 / 2
    assert st.counts["all-gather"] == 3
    # dp_only: no TP all-reduce, one gradient all-reduce over all 8
    dp = pspec_map(lambda s: PSpec(*((None,) * len(s))), tp)
    st = stats(dp, ("data", "model"))
    full = sum(t.numel() * t.element_size() for t in tree_leaves(meta))
    assert st.counts == {"all-reduce": 1}
    assert st.wire_bytes["all-reduce"] == full * 2 * 7 / 8
    # an MoE layer whose experts every device holds exchanges nothing
    moe = _one_layer("attn_moe", n_experts=8, experts_per_token=2,
                     moe_d_ff=32, moe_impl="a2a")
    mm = model_init(moe, None, device="meta")
    dpm = pspec_map(lambda s: PSpec(*((None,) * len(s))),
                    model_pspec(moe, axes))
    for pspec, want in ((dpm, 0.0), (model_pspec(moe, axes), 1.0)):
        st = collective_stats(moe, kind="prefill", seq_len=8,
                              global_batch=16, sizes=sizes,
                              param_pspec=pspec, params=mm,
                              batch_axes=("data", "model"))
        assert min(st.by_rule.get("moe", 0.0), 1.0) == want


def test_perf_log_and_pick_hillclimb_equal_reference(driven):
    ours = driven[0]
    assert perf_log_md.perf_log(ours) == ref_perf_log_md.perf_log(ours)
    sweep = [dryrun.plan_combo(a, s, multi_pod=mp, verbose=False)
             for a in ("qwen3-4b", "mamba2-780m", "gemma2-2b")
             for s in SHAPES for mp in (False, True)]
    assert report_md.pick_hillclimb(sweep) == ref_report_md.pick_hillclimb(
        sweep)
    picks = report_md.pick_hillclimb(sweep)
    assert picks["worst_useful_flops"]["shape"] == "train_4k"
    assert picks["most_collective_bound"]["mesh"] == "16x16"
