"""Port parity, the roofline: for all 11 configs × the 4 input shapes ×
the 2 production meshes, ``launch.dryrun.plan_combo``'s analytic terms
equal (float equality) the reference's ``analytic_terms`` on the same
counts, its model FLOPs the reference's ``model_flops``, its active
parameter count the reference's ``active_param_count`` of the
reference's own shapes, and its parameter count the reference's; each
rule of ``roofline.collectives`` against a hand count, each collective
timed on the link its group spans; and the markdown tables of
``roofline.report_md`` equal the reference's on the same records.
"""
import math
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import (get_config as ref_get_config,  # noqa: E402
                           input_specs as ref_input_specs,
                           shape_plan as ref_shape_plan,
                           train_grad_accum as ref_grad_accum)
from repro.models.transformer import model_init as ref_model_init  # noqa: E402
from repro.roofline import report_md as ref_report_md  # noqa: E402
from repro.roofline.analysis import model_flops as ref_model_flops  # noqa: E402
from repro.roofline.analytic import analytic_terms as ref_analytic_terms  # noqa: E402

from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch.dryrun import (active_param_count,  # noqa: E402
                                       one_card_bound, plan_combo)
from repro_torch.launch.mesh import H100_SXM, axis_span  # noqa: E402
from repro_torch.models import BlockGroup, ModelConfig  # noqa: E402
from repro_torch.models.common import Axes  # noqa: E402
from repro_torch.models.transformer import model_init, model_pspec  # noqa: E402
from repro_torch.roofline import report_md  # noqa: E402
from repro_torch.roofline.analysis import model_flops  # noqa: E402
from repro_torch.roofline.collectives import collective_stats  # noqa: E402


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's ``launch.dryrun`` (``active_param_count``): its
    import appends a 512-device flag to XLA_FLAGS, restored here (this
    process's backend is up already)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


@pytest.fixture(scope="module")
def ref_params():
    return {a: jax.eval_shape(lambda k, a=a: ref_model_init(
        ref_get_config(a), k), jax.random.PRNGKey(0)) for a in ARCH_IDS}


@pytest.fixture(scope="module")
def records():
    return {(a, s, mp): plan_combo(a, s, multi_pod=mp, verbose=False)
            for a in ARCH_IDS for s in SHAPES for mp in (False, True)}


def _ref_terms(ref_dryrun, ref_params, arch, shape, multi_pod, rec):
    """The reference's analytic terms of the combination, its own cache
    bytes and grad_accum, on the port's parameter counts."""
    s = SHAPES[shape]
    rc, _ = ref_shape_plan(ref_get_config(arch), shape)
    n_dev = 512 if multi_pod else 256
    cache = 0.0
    if s.kind == "decode":
        cache = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                    for l in jax.tree.leaves(ref_input_specs(rc, shape)[
                        "caches"]))
    ga = ref_grad_accum(arch) if s.kind == "train" else 1
    return ref_analytic_terms(
        rc, kind=s.kind, seq_len=s.seq_len, global_batch=s.global_batch,
        n_params=rec["n_params"], n_active_params=rec["n_active_params"],
        n_devices=n_dev, model_shards=16, data_shards=n_dev // 16,
        hw=H100_SXM, cache_bytes_total=cache, grad_accum=ga,
        param_shards=16, opt_shards=16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_terms_flops_and_counts_equal_reference(
        arch, records, ref_dryrun, ref_params):
    meta = model_init(get_config(arch), None, device="meta")
    ref_p = ref_params[arch]
    n_ref = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(ref_p))
    for shape in SHAPES:
        s = SHAPES[shape]
        for mp in (False, True):
            rec = records[(arch, shape, mp)]
            if rec["status"] == "skipped":
                assert ref_shape_plan(ref_get_config(arch), shape)[0] is None
                continue
            assert rec["status"] == "ok"
            assert rec["n_params"] == n_ref
            # the variant's counts are the base's (windows change no
            # parameter), as in the reference's lower_combo
            assert rec["n_active_params"] == ref_dryrun.active_param_count(
                ref_get_config(arch), ref_p) == active_param_count(
                    get_config(arch), meta)
            want = _ref_terms(ref_dryrun, ref_params, arch, shape, mp, rec)
            for k, v in want.items():
                assert rec[k] == v, (arch, shape, mp, k)
            tokens = s.global_batch * (s.seq_len if s.kind != "decode"
                                       else 1)
            mf = ref_model_flops(rec["n_active_params"], tokens,
                                 s.kind == "train")
            assert rec["model_flops_total"] == mf == model_flops(
                rec["n_active_params"], tokens, s.kind == "train")
            assert rec["useful_flops_ratio"] == mf / (
                want["analytic_flops"] * rec["n_devices"])
            assert rec["roofline_step_s"] == max(
                want["analytic_compute_s"], want["analytic_memory_s"],
                rec["collective_s"])
            assert rec["hbm_ok"] == (rec["bytes_per_device"]["peak_hbm_est"]
                                     <= 80e9)


def _one_layer(kind="attn", **kw):
    base = dict(name="t", arch_type="dense", d_model=64, vocab_size=128,
                blocks=(BlockGroup((kind,), 1),), n_heads=8, n_kv_heads=8,
                head_dim=8, d_ff=128, remat="block")
    base.update(kw)
    return ModelConfig(**base)


def _stats(cfg, kind, sizes, batch=4, seq=8, batch_axes=("data",)):
    axes = Axes(model_size=sizes["model"])
    return collective_stats(
        cfg, kind=kind, seq_len=seq, global_batch=batch, sizes=sizes,
        param_pspec=model_pspec(cfg, axes),
        params=model_init(cfg, None, device="meta"), batch_axes=batch_axes)


def test_collective_rules_against_hand_counts():
    sizes = {"data": 2, "model": 4}
    act = (4 // 2) * 8 * 64 * 2.0               # T × d × 2 bytes a device
    # one TP layer: two all-reduces (mixer, FFN) over model (n = 4)
    cfg = _one_layer()
    st = _stats(cfg, "prefill", sizes)
    assert st.counts == {"all-reduce": 2}
    assert st.wire_bytes["all-reduce"] == 2 * act * 2 * 3 / 4
    # train: three passes under block remat, two without
    st = _stats(cfg, "train", sizes)
    assert st.by_rule["tp"] == 3 * 2 * act * 2 * 3 / 4
    st = _stats(_one_layer(remat="none"), "train", sizes)
    assert st.by_rule["tp"] == 2 * 2 * act * 2 * 3 / 4
    # one DP sync: a device's gradient bytes (its model shard) over data
    meta = model_init(cfg, None, device="meta")
    shard = {"wq": 4, "wk": 4, "wv": 4, "wo": 4, "w_gate": 4, "w_up": 4,
             "w_down": 4, "table": 4, "head": 4}
    grad = 0.0
    for name, t in [("table", meta["embed"]["table"]),
                    ("head", meta["embed"]["head"]),
                    ("scale", meta["final_norm"]["scale"])] + [
            (k, v) for part in ("mixer", "ffn")
            for k, v in meta["groups"][0][0][part].items()] + [
            ("scale", meta["groups"][0][0][n]["scale"])
            for n in ("norm_mix", "norm_ffn")]:
        grad += t.numel() * t.element_size() / shard.get(name, 1)
    st = _stats(cfg, "train", sizes)
    assert st.by_rule["dp"] == grad * 2 * 1 / 2
    # one a2a MoE layer: two all-to-alls of the T × k routed rows
    moe = dict(n_experts=8, experts_per_token=2, moe_d_ff=32)
    st = _stats(_one_layer("attn_moe", moe_impl="a2a", **moe), "prefill",
                sizes)
    assert st.by_rule["moe"] == 2 * act * 2 * 3 / 4
    assert st.counts == {"all-reduce": 1, "all-to-all": 2}
    # one eshard MoE layer: one all-reduce of (T, d) over model
    st = _stats(_one_layer("attn_moe", moe_impl="eshard", **moe), "prefill",
                sizes)
    assert st.by_rule["moe"] == act * 2 * 3 / 4
    # scatter: the (E_local, C, d) buffer over the data axes (n = 2)
    st = _stats(_one_layer("attn_moe", **moe), "decode", sizes)
    assert st.by_rule["moe"] == (8 // 4) * 2 * 64 * 2.0 * 2 * 1 / 2
    # one device: no wire
    assert _stats(cfg, "train", {"model": 1},
                  batch_axes=()).total_wire_bytes == 0


def test_collectives_run_on_the_link_their_group_spans(records):
    # devices run row-major over the mesh, 8 to an NVLink node
    assert H100_SXM.node_size == 8
    sizes = {"data": 4, "model": 4}
    assert axis_span(sizes, ("model",)) == 4
    assert axis_span(sizes, ("data",)) == 16
    assert axis_span({"pod": 2, "data": 16, "model": 16},
                     ("pod", "data")) == 512
    # (data=4, model=4): the model groups stay inside a node, the data
    # groups cross nodes
    st = _stats(_one_layer(), "train", sizes, batch=8)
    assert st.by_rule["tp"] > 0 and st.by_rule["dp"] > 0
    assert math.isclose(st.seconds, st.by_rule["tp"] / 450e9
                        + st.by_rule["dp"] / 50e9, rel_tol=1e-12)
    # 16 x 16: every group is wider than a node
    st = _stats(_one_layer(), "prefill", {"data": 16, "model": 16},
                batch=16)
    assert st.total_wire_bytes > 0
    assert math.isclose(st.seconds, st.total_wire_bytes / 50e9,
                        rel_tol=1e-12)
    # the plan's collective term is the schedule's seconds
    for key in (("qwen3-4b", "train_4k", False),
                ("deepseek-v3-671b", "prefill_32k", True)):
        rec = records[key]
        assert rec["collective_s"] == rec["collectives"]["seconds"] > 0
        assert math.isclose(rec["collective_s"],
                            rec["wire_bytes"] / 50e9, rel_tol=1e-12)


def test_one_card_bound_is_the_single_device_terms():
    cfg = get_config("gemma2-2b")
    b = one_card_bound(cfg, kind="decode", seq_len=96, global_batch=4)
    assert b["n_params"] == 2_506_172_416
    assert b["bound_s"] == max(b["analytic_compute_s"],
                               b["analytic_memory_s"])
    # decode reads every bf16 param once and the caches twice: 18 attn
    # layers of k and v (4 × 96 slots × 1 head × 256, bf16) and pos
    cache = 18 * (2 * 4 * 96 * 1 * 256 * 2 + 96 * 4)
    assert b["analytic_bytes"] == 2.0 * b["n_params"] + 2.0 * cache
    t = one_card_bound(cfg, kind="train", seq_len=128, global_batch=4)
    assert t["analytic_flops"] == 4.0 * (
        2.0 * t["n_params"] * 512 + 4.0 * 4 * 128 * 8 * 256 * 18 * 64)


def test_report_tables_equal_reference(records):
    recs = [records[k] for k in sorted(records)]
    for mesh in ("16x16", "2x16x16"):
        assert report_md.roofline_table(recs, mesh) == \
            ref_report_md.roofline_table(recs, mesh)
    for x in (0.5, 1023.0, 5e6, 3e12, 2e15):
        assert report_md.fmt_bytes(x) == ref_report_md.fmt_bytes(x)
    for x in (2e-7, 3.5e-4, 0.25, 12.0):
        assert report_md.fmt_s(x) == ref_report_md.fmt_s(x)
    table = report_md.dryrun_table(recs, "16x16")
    assert "fits 80G" in table and table.count("SKIP") == 2
    assert len(table.splitlines()) == 2 + 44
