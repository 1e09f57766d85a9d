"""Each metric's reader on a synthetic record, against the value worked
out by hand; and on the record of a traced run at a tiny size."""
import time

import pytest
import torch

from perfbench.lib import cell
from perfbench.lib.trace import reduce_events
from perfbench.roofline import least
from perfbench.roofline.peaks import HBM_BYTES_PER_S
from perfbench.roofline.ring import codec_bytes, sync_bytes

MAMBA = cell.config("mamba2-780m")["model"]


def read(name, rec):
    return cell.load_module("metrics", name).read(rec)


def serve_record():
    calls = [{"wall_s": 1.0, "prompt_len": 8, "steps": [0.1, 0.2, 0.3],
              "traced": False, "mismatch": 0.0},
             {"wall_s": 2.0, "prompt_len": 8, "steps": [0.4, 0.5, 0.6],
              "traced": True, "mismatch": 0.0},
             {"wall_s": 1.5, "prompt_len": 8, "steps": [0.2, 0.2, 0.4],
              "traced": False, "mismatch": 0.0}]
    trace = {"slice_s": 2.0, "busy_s": 1.5,
             "op_s": {"encode_lookup_kernel": 0.03, "pack_blocks_kernel":
                      0.01, "decode_multisym_kernel": 0.02,
                      "histogram256_kernel": 0.0, "gemm": 1.0},
             "op_n": {}, "gap_s": {}, "span_n": {}, "device_kinds": []}
    return {"model": MAMBA, "batch": 2, "new_tokens": 4, "prefix_len": 0,
            "cache_len": 12, "setup_s": 7.5, "window_s": 5.0,
            "calls": calls, "trace": trace}


def test_serve_readers():
    rec = serve_record()
    assert read("setup_s", rec) == 7.5
    assert read("serve_tok_s", rec) == pytest.approx(3 * 2 * 4 / 5.0)
    # 9 steps, each twice (a gap a request): 18 gaps, the 95th
    # percentile lies between the two 0.6 s gaps
    assert read("itl_p95_ms", rec) == pytest.approx(600.0)
    assert read("decode_step_ms.serve", rec) == pytest.approx(200.0)
    # a call less its steps after the first and one median step
    assert read("prefill_ms.serve", rec) == pytest.approx(
        ((1.0 - 0.5 - 0.25) + (1.5 - 0.6 - 0.3)) / 2 * 1e3)
    assert read("codec_ms.serve", rec) == pytest.approx(60.0 / 3)
    assert read("idle_share.serve", rec) == pytest.approx(25.0)
    want = 0.0
    for _ in (0, 2):
        want += least.prefill_bound_s(MAMBA, 2, 8, 8, 12)
        want += sum(least.decode_bound_s(MAMBA, 2, 8 + i) for i in range(3))
    assert read("step_mfu.serve", rec) == pytest.approx(
        100 * want / 2.5)


def test_readers_give_nothing_without_a_trace():
    rec = serve_record()
    rec["trace"] = None
    assert read("codec_ms.serve", rec) is None
    assert read("idle_share.serve", rec) is None
    rec["trace"] = dict(serve_record()["trace"], busy_s=0.0)
    assert read("idle_share.serve", rec) is None


def test_sync_readers():
    hop = [[8e6, 7e6], [4e6, 3e6]]
    rec = {"ranks": 2, "size": 300, "buckets": [200, 100], "hop_bits": hop,
           "syncs": 6, "sync_s": [0.5, 0.25, 1.0], "setup_s": 1.0,
           "window_s": 3.0,
           "trace": {"slice_s": 1.0, "busy_s": 0.8,
                     "op_s": {"decode_multisym_kernel": 0.002,
                              "encode_lookup_kernel": 0.001,
                              "pack_blocks_kernel": 0.003,
                              "histogram256_kernel": 0.001,
                              "add": 0.004, "roll": 0.005},
                     "op_n": {}, "gap_s": {}, "span_n": {},
                     "device_kinds": []}}
    assert read("allreduce_gbps", rec) == pytest.approx(
        2 * 300 * 6 / 3.0 / 1e9)
    # codec: each hop n·b/8 coded bytes and n·seg·2 symbols
    cb = (2 * 8e6 / 8 + 2 * 100 * 2) + (2 * 7e6 / 8 + 2 * 100 * 2) + (
        2 * 4e6 / 8 + 2 * 50 * 2) + (2 * 3e6 / 8 + 2 * 50 * 2)
    assert codec_bytes(rec["buckets"], hop, 2) == pytest.approx(cb)
    assert read("decode_roofline.sync", rec) == pytest.approx(
        100 * cb / HBM_BYTES_PER_S / 0.002)
    assert read("encode_roofline.sync", rec) == pytest.approx(
        100 * cb / HBM_BYTES_PER_S / 0.004)
    assert read("hop_torch_ms.sync", rec) == pytest.approx(9.0)
    sb = (2 * 2 * (8e6 + 7e6) / 8 + 1 * 2 * 100 * 2 + 2 * 200 * 2) + (
        2 * 2 * (4e6 + 3e6) / 8 + 1 * 2 * 50 * 2 + 2 * 100 * 2)
    assert sync_bytes(rec["buckets"], hop, 2) == pytest.approx(sb)
    assert read("sync_mfu.sync", rec) == pytest.approx(
        100 * sb / HBM_BYTES_PER_S / 0.5)
    assert read("idle_share.sync", rec) == pytest.approx(20.0)


class _Event:
    def __init__(self, name, start, end, device, kind="", user=False):
        self._v = (name, start, end, device, kind, user)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType." + self._v[3]

    def activity_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_reduction():
    ev = [_Event("k1", 50, 150, "CUDA", "kernel"),
          _Event("k2", 120, 300, "CUDA", "kernel"),
          _Event("k1", 600, 700, "CUDA", "kernel"),
          _Event("note", 0, 1000, "CUDA", "gpu_user_annotation"),
          _Event("aten::add", 10, 20, "CPU")]
    spans = [(100, 500, "serve.decode_step"), (0, 1000, "serve.generate")]
    s = reduce_events(ev, spans, (0, 1000))
    assert s["slice_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx(350e-9)
    assert s["op_s"] == pytest.approx({"k1": 200e-9, "k2": 180e-9})
    # gaps: [0,50) generate, [300,600) decode_step (mid 450),
    # [700,1000) generate
    assert s["gap_s"]["serve.decode_step"] == pytest.approx(300e-9)
    assert s["gap_s"]["serve.generate"] == pytest.approx(350e-9)
    assert s["first_op_s"] == pytest.approx(50e-9)
    assert s["after_last_op_s"] == pytest.approx(300e-9)


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cell.benchmark()["workloads"]])
def test_a_traced_run_reads_the_programs_spans_and_counters(workload):
    """A run with ``--trace 1`` on the CPU, at a tiny size: every
    per-layer metric of the cell read from the program's spans and
    counters is there (those of the device trace need the card)."""
    from perfbench.run import run_cell
    from perfbench.tests import tiny
    w = cell.workload(workload)
    r = run_cell(workload, 2**31 + 11, 0.05, True, torch.device("cpu"),
                 time.perf_counter(), overrides=tiny.overrides(w))
    want = {m["name"] for m in cell.cell_metrics(cell.benchmark(), workload,
                                                 True)
            if m["source"] in ("program_span", "program_counter")}
    assert want and want <= set(r["metrics"]), r["metrics"]
    assert r["correct"], r["checks"]
