"""Kernel B5's schedule and ``CompressionSpec``'s two members, on the CPU.

B5 (``src/repro_torch/kernels/csrc/histogram.cu``) runs only on the card,
so its work split is spelled out here as a numpy model, with the
constants and the grid pick that the wrapper (``kernels/histogram.py``)
passes to the launch: over lengths and start offsets (the address mod
16) the model counts every byte exactly once, no CTA counts more symbols
than the launch's exactness check allows its 32-bit bins (on a plane of
one symbol value they all land in one bin), and the histogram it
gathers equals ``histogram256_plain`` and the reference's
``histogram256_pallas`` in interpret mode.  ``CompressionSpec.off()``
and ``lengths_for`` are held to the reference's on specs from the same
books.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.comm.compression import CompressionSpec as RefSpec  # noqa: E402
from repro.core.codebook import build_codebook as ref_build  # noqa: E402
from repro.kernels.histogram import histogram256_pallas  # noqa: E402

from repro_torch.comm.compression import CompressionSpec  # noqa: E402
from repro_torch.core.codebook import build_codebook  # noqa: E402
from repro_torch.kernels import histogram as b5  # noqa: E402

CU = (Path(b5.__file__).resolve().parent / "csrc" / "histogram.cu"
      ).read_text()
# One wave of an H100 as the model takes it: 8 CTAs of 256 threads on
# each of 132 SMs (on the card the wrapper asks the occupancy query).
WAVE = 8 * 132


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


def _schedule(n, offset, wave=WAVE):
    """The kernel's split of ``n`` bytes starting at address ``offset``
    mod 16: (position → times counted, CTA → symbols it counts, the
    launch's bound on them, grid, the positions counted)."""
    grid = b5.launch_grid(n, wave)
    head = min((16 - offset) % 16, n)
    n_vec = (n - head) // 16
    tail = n - head - 16 * n_vec
    # load i (16 bytes from head + 16 i): CTA (i // THREADS) % grid, a
    # grid-stride loop; head and tail bytes: CTA 0
    i = np.arange(n_vec)
    cta = (i // b5.THREADS) % grid
    pos = np.concatenate([np.arange(head),
                          (head + 16 * i[:, None] + np.arange(16)).ravel(),
                          np.arange(n - tail, n)])
    times = np.bincount(pos, minlength=n)[:n]
    per_cta = 16 * np.bincount(cta, minlength=grid)
    per_cta[0] += head + tail
    bound = 16 * (-(-n_vec // grid) + b5.THREADS) + 31
    return times, per_cta, bound, grid, pos


def test_constants_match_the_kernel_source():
    assert b5.THREADS == _cu_const("kThreads") == 256
    assert _cu_const("kBins") == 256
    # The grid: one wave on large planes, 4 loads a thread on a logits
    # plane (1 024 000 symbols: 63 CTAs, 64 symbols a thread), one CTA on
    # an empty one.
    assert b5.MIN_LOADS == 4
    assert b5.launch_grid(1 << 25, WAVE) == WAVE
    assert b5.launch_grid(1_024_000, WAVE) == 63
    assert b5.launch_grid(0, WAVE) == b5.launch_grid(17, WAVE) == 1


@pytest.mark.parametrize("n", [0, 1, 15, 17, 4097, (1 << 20) + 3])
def test_schedule_counts_every_byte_once(n):
    rng = np.random.default_rng(n)
    data = np.minimum(rng.geometric(0.02, n + 16), 255).astype(np.uint8)
    for offset in range(16):
        times, per_cta, bound, grid, pos = _schedule(n, offset)
        assert (times == 1).all(), (n, offset)
        assert 1 <= grid <= WAVE
        # the launch's exactness check covers every CTA's count, and it
        # holds for 32-bit bins
        assert per_cta.max() <= bound <= 0xFFFFFFFF, (n, offset)
        sym = data[offset:offset + n]
        hist = np.bincount(sym[pos], minlength=256)
        np.testing.assert_array_equal(
            hist, b5.histogram256_plain(torch.from_numpy(sym)).numpy())


def test_schedule_bounds_a_large_plane():
    # a stacked gemma2-2b FFN weight plane (18 x 2048 x 16384 symbols),
    # the largest the store feeds B5, in one CTA's worst case
    n = 18 * 2048 * 16384
    grid = b5.launch_grid(n, WAVE)
    assert grid == WAVE
    assert 16 * (-(-n // 16 // grid) + b5.THREADS) + 31 < 1 << 32


@pytest.mark.parametrize("n", [17, 4097])
def test_schedule_histogram_equals_pallas(n):
    rng = np.random.default_rng(7 + n)
    sym = np.minimum(rng.geometric(0.05, n), 255).astype(np.uint8)
    want = np.asarray(histogram256_pallas(jnp.asarray(sym)))
    for offset in (0, 9):
        *_, pos = _schedule(n, offset)
        np.testing.assert_array_equal(np.bincount(sym[pos], minlength=256),
                                      want)
    np.testing.assert_array_equal(
        b5.histogram256(torch.from_numpy(sym)).numpy(), want)


@pytest.mark.parametrize("codec", ["huffman", "qlc"])
def test_compression_spec_off_and_lengths_for(codec):
    rng = np.random.default_rng(3)
    counts = {p: np.maximum(rng.integers(0, 5000, 256) ** 2, 1)
              for p in ("lo", "hi")}
    books = {p: build_codebook(c, codec=codec) for p, c in counts.items()}
    ref_books = {p: ref_build(c, codec=codec) for p, c in counts.items()}
    spec = CompressionSpec.from_books(books, "bf16")
    ref = RefSpec.from_books(ref_books, "bf16")
    for p in ("lo", "hi"):
        got, want = spec.lengths_for(p), ref.lengths_for(p)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == (256,)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(KeyError):
        spec.lengths_for("b0")
    off, ref_off = CompressionSpec.off(), RefSpec.off()
    assert off.mode == ref_off.mode == "off"
    assert not off.enabled and not ref_off.enabled
    for field in ("scheme_name", "tensor_kind", "plane_lengths", "transport",
                  "chunk", "codec", "decode_backend", "carry", "axes"):
        assert getattr(off, field) == getattr(ref_off, field), field
    assert off == CompressionSpec(mode="off") and hash(off) == hash(
        CompressionSpec.off())
