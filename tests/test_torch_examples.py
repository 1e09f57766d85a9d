"""Port parity, the three examples run on the CPU (``device="cpu"``: the
kernels' plain versions).

``quickstart``: its byte planes, books' coded bits, three-stage oracle
bits, compressibilities and best-book choice equal the reference
quickstart's functions (``bf16_planes_np`` of an ``ml_dtypes`` cast,
``CodebookRegistry``, ``single_stage_encode``, ``three_stage_encode``,
``select_best``) on the same numpy data.  ``serve_compressed``: the
gather is bit-exact and its coded bits are the histogram · lengths; the
ring's hops and its ranks agree.  ``train_sft_compressed`` at d 64, 2
layers, 3 steps, vocab 256, a rebuild every 2 steps: its model is the
reference example's (parameter count), its losses finite, and the
rebuilt books code the gradients smaller.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import (CodebookRegistry as RefRegistry,  # noqa: E402
                        single_stage_encode as ref_single_stage,
                        three_stage_encode as ref_three_stage)
from repro.core.symbols import bf16_planes_np as ref_planes_np  # noqa: E402
from repro.models import (BlockGroup as RefBlockGroup,  # noqa: E402
                          ModelConfig as RefModelConfig,
                          model_init as ref_model_init)

from repro_torch.core.symbols import bf16_bits_np, bf16_planes_np  # noqa: E402
from repro_torch.examples import (quickstart,  # noqa: E402
                                  serve_compressed, train_sft_compressed)


def test_bf16_bits_equal_ml_dtypes_cast():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=1 << 16),
                        np.ldexp(rng.random(4096) + 1,
                                 rng.integers(-150, 130, 4096)),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 1 + 2 ** -8,
                         3.3895e38, 1e-45, -2 ** -130]])
    with np.errstate(over="ignore"):
        want = x.astype(jnp.bfloat16).view(np.uint16)
    assert np.array_equal(bf16_bits_np(x), want)


def test_quickstart_equals_reference_functions():
    rec = quickstart.main([], device="cpu")
    rng = np.random.default_rng(0)
    previous = rng.normal(size=1 << 18).astype(jnp.bfloat16)
    batch = rng.normal(size=1 << 16).astype(jnp.bfloat16)
    registry = RefRegistry()
    for plane, sym in ref_planes_np(previous).items():
        registry.install(("ffn1_act", "bf16", plane),
                         np.bincount(sym, minlength=256))
    planes = ref_planes_np(batch)
    again = np.random.default_rng(0)
    again.normal(size=1 << 18)
    for plane, sym in bf16_planes_np(again.normal(size=1 << 16)).items():
        assert np.array_equal(sym, planes[plane])
    coded = oracle = 0
    for plane, sym in planes.items():
        book = registry.get(("ffn1_act", "bf16", plane))
        bits = int(ref_single_stage(jnp.asarray(sym), book).n_bits)
        bits3 = int(ref_three_stage(sym)[0].n_bits)
        got = rec["planes"][plane]
        assert (got["coded_bits"], got["oracle_bits"]) == (bits, bits3)
        assert got["histogram_dot_lengths"] == bits and got["lossless"]
        coded, oracle = coded + bits, oracle + bits3
    raw = 8 * (1 << 16) * 2
    assert rec["fixed_compressibility"] == 1 - coded / raw
    assert rec["oracle_compressibility"] == 1 - oracle / raw
    bid, ebits = registry.select_best(np.bincount(planes["hi"],
                                                  minlength=256))
    assert (rec["select_best"]["book_id"],
            rec["select_best"]["bits_per_symbol"]) == (bid, ebits)


def test_serve_compressed_gather_is_bitexact():
    rec = serve_compressed.main([], device="cpu")
    assert rec["generated_shape"] == [4, 24]
    g = rec["gather"]
    assert g["bitexact"]
    assert g["coded_bits"] == 8 * g["histogram_dot_lengths"] > 0
    assert g["raw_bits"] == 8 * 8 * 64 * 256 * 16     # 8 ranks x 8 shards
    r = rec["ring"]
    assert r["hops"] == 2 * (8 - 1) and r["finite"] and r["ranks_agree"]
    assert 0 < r["coded_wire_bits"] < r["raw_wire_bits"]


def test_train_sft_small_run():
    argv = ["--d-model", "64", "--layers", "2", "--steps", "3",
            "--vocab", "256", "--rebuild-every", "2"]
    rec = train_sft_compressed.main(argv, device="cpu")
    ref_cfg = RefModelConfig(
        name="gemma-sft-100m", arch_type="dense", d_model=64,
        vocab_size=256, blocks=(RefBlockGroup(("attn",), 2),), n_heads=1,
        n_kv_heads=1, head_dim=64, d_ff=256, ffn_activation="gelu",
        tie_embeddings=True, remat="block")
    shapes = jax.eval_shape(lambda k: ref_model_init(ref_cfg, k),
                            jax.random.PRNGKey(0))
    assert rec["params"] == sum(int(np.prod(l.shape))
                                for l in jax.tree.leaves(shapes))
    assert len(rec["losses"]) == 3 and all(map(np.isfinite, rec["losses"]))
    assert rec["rebuild_steps"] == [1]
    r = rec["rebuilds"][0]
    assert r["coded_over_raw_after"] < r["coded_over_raw_before"]
    assert rec["ledger"][0]["calls"] == 3
