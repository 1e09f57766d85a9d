"""The frozen counts against the program's ``launch/dryrun.py``
``one_card_bound`` on every cell's shapes, and the parameter counts
against the program's model."""
import pytest

from perfbench.lib import cell
from perfbench.roofline import analytic, least, peaks

SHAPES = [  # (config, kind, seq_len, batch): the cells' steps
    ("mamba2-780m", "prefill", 256, 64),
    ("mamba2-780m", "decode", 384, 64),
    ("mamba2-780m", "train", 4096, 1),
    ("internvl2-26b", "prefill", 1088, 4),
    ("internvl2-26b", "decode", 1120, 4),
]


@pytest.mark.parametrize("name,kind,seq,batch", SHAPES)
def test_one_card_bound_is_the_programs(name, kind, seq, batch):
    from repro_torch.launch.dryrun import one_card_bound
    conf = cell.config(name)
    want = one_card_bound(cell.model_config(conf), kind=kind, seq_len=seq,
                          global_batch=batch)
    got = analytic.one_card_bound(conf["model"], kind=kind, seq_len=seq,
                                  global_batch=batch)
    for k in ("analytic_flops", "analytic_bytes", "analytic_compute_s",
              "analytic_memory_s", "bound_s", "n_params"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


@pytest.mark.parametrize("name", ["mamba2-780m", "internvl2-26b"])
def test_parameter_counts_and_bytes(name):
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_init
    conf = cell.config(name)
    leaves = tree_leaves(model_init(cell.model_config(conf), None,
                                    device="meta"))
    assert analytic.param_count(conf["model"]) == sum(
        t.numel() for t in leaves)
    assert analytic.param_bytes(conf["model"]) == sum(
        t.numel() * t.element_size() for t in leaves)
    assert analytic.param_count(conf["model"]) == {
        "mamba2-780m": 779_989_248,
        "internvl2-26b": 19_861_260_288}[name]


def test_peaks_and_least_counts():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
    m = cell.config("mamba2-780m")["model"]
    # a mamba decode step: weights once, state read and written once
    state = analytic.cache_bytes(m, 64, 0)
    assert least.decode_bytes(m, 64, 300) == analytic.param_bytes(m) \
        + 2 * state
    v = cell.config("internvl2-26b")["model"]
    kv = 2 * 4 * 8 * 128 * 2 * 48
    table = 2 * v["vocab_size"] * v["d_model"]
    assert least.decode_bytes(v, 4, 1100) == analytic.param_bytes(v) \
        - table + 2 * 4 * v["d_model"] + kv * 1101
    # the prefill's head runs over the token positions only
    body = analytic.param_count(v) - 2 * v["vocab_size"] * v["d_model"]
    attn = 4 * 4 * 1088 * 48 * 128 * 544 * 48
    assert least.prefill_flops(v, 4, 1088, 64) == pytest.approx(
        2 * body * 4 * 1088 + 2 * v["vocab_size"] * v["d_model"] * 4 * 64
        + attn)
    assert least.train_flops(m, 1, 4096) == pytest.approx(
        3 * 2 * analytic.param_count(m) * 4096)
