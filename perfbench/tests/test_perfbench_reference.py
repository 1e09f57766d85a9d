"""The plain reference against the program at tiny sizes on the CPU: the
Mamba-2 and InternLM2-with-prefix logits, the books' lengths and coded
sizes, and the uncoded ring's sums and hop bits."""
import numpy as np
import pytest
import torch

from perfbench.lib import cell
from perfbench.lib.weights import make_params
from perfbench.reference import huffman, internlm2, mamba2
from perfbench.reference import ring as ref_ring
from perfbench.reference.common import Precision
from perfbench.tests import tiny

CPU = torch.device("cpu")


def _tiny(name):
    conf = cell.config(name)
    m = dict(conf["model"], **tiny.MODELS[name])
    return conf, m, cell.model_config(conf, tiny.MODELS[name])


def _port_logits(cfg, params, batch):
    """The program's full-sequence forward in float32 on float32 copies
    of the same weights."""
    from dataclasses import replace

    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import forward
    p32 = tree_map(lambda t: t.to(torch.float32), params)
    return forward(p32, batch, replace(cfg, dtype=torch.float32))


@pytest.mark.parametrize("first", [0, 7])
def test_mamba2_equals_the_program(first):
    conf, m, cfg = _tiny("mamba2-780m")
    params = make_params(cfg, 11, CPU)
    tokens = torch.randint(0, m["vocab_size"], (3, 20),
                           generator=torch.Generator().manual_seed(1))
    want = _port_logits(cfg, params, {"tokens": tokens})[:, first:]
    got = mamba2.logits(params, tokens, m, first)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-4, float(err)


def test_internlm2_with_prefix_equals_the_program():
    conf, m, cfg = _tiny("internvl2-26b")
    params = make_params(cfg, 12, CPU)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, m["vocab_size"], (2, 9), generator=g)
    prefix = (torch.randn((2, m["prefix_len"], m["d_model"]), generator=g)
              * m["d_model"] ** -0.5).to(torch.bfloat16)
    want = _port_logits(cfg, params, {"tokens": tokens,
                                      "prefix_embeds": prefix})[:, 3:]
    got = internlm2.logits(params, tokens, m, 3, prefix=prefix)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 1e-4, float(err)


@pytest.mark.parametrize("name", ["mamba2-780m", "internvl2-26b"])
def test_the_control_precision_departs(name):
    conf, m, cfg = _tiny(name)
    params = make_params(cfg, 13, CPU)
    model = mamba2 if name.startswith("mamba") else internlm2
    tokens = torch.randint(0, m["vocab_size"], (2, 12),
                           generator=torch.Generator().manual_seed(3))
    kw = {}
    if m.get("prefix_len"):
        kw["prefix"] = torch.zeros((2, m["prefix_len"], m["d_model"]))
    ref = model.logits(params, tokens, m, 0, **kw)
    low = model.logits(params, tokens, m, 0, prec=Precision("fp8"), **kw)
    rel = float((low - ref).abs().max() / ref.abs().max())
    assert 1e-3 < rel < 0.5, rel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_book_lengths_and_coded_bits_equal_the_program(seed):
    from repro_torch.comm.compression import CompressionSpec, payload_stats
    from repro_torch.core.codebook import build_codebook
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(5000, generator=g) * (10.0 ** -seed)).to(
        torch.bfloat16)
    ref = huffman.books_of(x)
    planes = huffman.bf16_planes(x)
    books = {p: build_codebook(np.bincount(planes[p].numpy(),
                                           minlength=256), key=("a", "b", p))
             for p in huffman.PLANES}
    for p in huffman.PLANES:
        assert (books[p].lengths == ref[p]).all()
    spec = CompressionSpec.from_books(books, "bf16", mode="ledger")
    y = torch.randn(3000, generator=g).to(torch.bfloat16)
    assert payload_stats(y, spec)["coded_bits"].item() == \
        huffman.coded_bits(y, ref)


@pytest.mark.parametrize("size", [4096, 4099])
def test_ring_sum_and_hop_bits_equal_the_program(size):
    from repro_torch.comm import LoopbackAxis, ring_all_reduce
    from repro_torch.core.codebook import build_codebook
    g = torch.Generator().manual_seed(size)
    x = (torch.randn((4, size), generator=g) * 1e-2).to(torch.bfloat16)
    earlier = (torch.randn(size, generator=g) * 1e-2).to(torch.bfloat16)
    planes = huffman.bf16_planes(earlier)
    books = {p: build_codebook(np.bincount(planes[p].numpy(),
                                           minlength=256), key=("g", "b", p))
             for p in huffman.PLANES}
    y, st = ring_all_reduce(x, LoopbackAxis(4), books, "bf16", chunk=256,
                            decode_backend="multisym", carry="wire")
    want, shipped = ref_ring.ring_all_reduce(x)
    assert torch.equal(y.view(torch.int16), want.view(torch.int16))
    lens = huffman.books_of(earlier)
    hop = [huffman.coded_bits(s, lens) / 4 for s in shipped]
    assert st["hop_coded_bits"].shape == (4, 6)
    assert (st["hop_coded_bits"].numpy() == np.asarray(hop)[None]).all()
    low, _ = ref_ring.ring_all_reduce(x, add_dtype=torch.float8_e4m3fn)
    assert not torch.equal(low.view(torch.int16), want.view(torch.int16))
