"""Plain InternLM2 decoder after an image prefix (InternVL2,
arXiv:2404.16821), float32, over the served parameter tree.

The input is [prefix embeddings] + [token embeddings], the prefix
rounded to bfloat16 as the served model takes it, all times √d (√d
rounded to bfloat16).  Each of the layers: pre-norm residual GQA
attention (``n_heads`` query heads over ``n_kv_heads`` key/value heads
of ``head_dim``, rotary embedding of base ``rope_theta`` on the two
halves of each head, causal softmax in float32 at 1/√head_dim), then a
pre-norm residual SwiGLU FFN (SiLU(x·Wg) ⊙ x·Wu)·Wd.  A final RMSNorm
and an untied head give the logits at the token positions.  Every
RMSNorm scales by (1 + scale).  Departures from the published model,
which the served model shares: the √d input factor and the (1 + scale)
norms; the vision tower and projector are not run (the prefix stands
for their output).

The parameters are the benchmark's own tensors in the served tree's
layout (``embed.table``/``head``, one stacked group of ``attn`` blocks,
``final_norm``), upcast a layer at a time.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .common import Precision, embed_scale, rmsnorm, silu
from .mamba2 import _layer


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, u, m: Dict, cos, sin, prec: Precision):
    bsz, s, _ = u.shape
    kvh, hd = m["n_kv_heads"], m["head_dim"]
    q = _rope(prec.einsum("bsd,dhk->bshk", u, p["wq"]), cos, sin)
    k = _rope(prec.einsum("bsd,dhk->bshk", u, p["wk"]), cos, sin)
    v = prec.einsum("bsd,dhk->bshk", u, p["wv"])
    q = q.reshape(bsz, s, kvh, m["n_heads"] // kvh, hd)
    scores = prec.einsum("bskgd,btkd->bkgst", q, k) * hd ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=u.device).tril()
    w = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = prec.einsum("bkgst,btkd->bskgd", w, v).reshape(
        bsz, s, m["n_heads"], hd)
    return prec.einsum("bshk,hkd->bsd", out, p["wo"])


@torch.no_grad()
def logits(params, tokens: torch.Tensor, m: Dict, first: int,
           prefix: Optional[torch.Tensor] = None,
           prec: Precision = Precision()) -> torch.Tensor:
    """Logits (B, S_tok − first, V), float32, at token positions
    ``first`` … S_tok − 1 of ``tokens`` (B, S_tok) after ``prefix``
    (B, P, d)."""
    table = params["embed"]["table"]
    parts = [] if prefix is None else [
        prefix.to(torch.bfloat16).to(torch.float32)]
    parts.append(table[tokens].to(torch.float32))
    x = torch.cat(parts, dim=1) * embed_scale(m["d_model"])
    npre = 0 if prefix is None else prefix.shape[1]
    s, hd = x.shape[1], m["head_dim"]
    pos = torch.arange(s, device=x.device, dtype=torch.float32)
    freqs = 1.0 / (m["rope_theta"] ** (torch.arange(
        0, hd, 2, device=x.device, dtype=torch.float32) / hd))
    ang = pos[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    stack = params["groups"][0][0]
    for i in range(m["n_layers"]):
        p = _layer(stack, i)
        u = rmsnorm(x, p["norm_mix"]["scale"], m["norm_eps"])
        x = x + _attention(p["mixer"], u, m, cos, sin, prec)
        u = rmsnorm(x, p["norm_ffn"]["scale"], m["norm_eps"])
        f = p["ffn"]
        x = x + prec.einsum("bsf,fd->bsd", silu(prec.einsum(
            "bsd,df->bsf", u, f["w_gate"])) * prec.einsum(
            "bsd,df->bsf", u, f["w_up"]), f["w_down"])
    x = rmsnorm(x[:, npre + first:], params["final_norm"]["scale"],
                m["norm_eps"])
    return prec.einsum("bsd,dv->bsv", x, params["embed"]["head"])
