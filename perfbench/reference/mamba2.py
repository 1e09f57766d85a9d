"""Plain Mamba-2 language model (arXiv:2405.21060), float32, over the
served parameter tree.

The block, as the configuration serves it: pre-norm residual; from the
normed input u, the projections z = u·Wz, x = u·Wx, B = u·WB, C = u·WC
and dt = softplus(u·Wdt + dt_bias); depthwise causal convs of width
``ssm_conv`` on x, B and C, each followed by SiLU; the selective scan
run as its recurrence, one position after another,

    h_t = exp(dt_t · A) · h_{t-1} + dt_t · x_t ⊗ B_t,   A = −exp(A_log)
    y_t = h_t · C_t + D · x_t

(each group's B and C shared by its heads); then y ⊙ SiLU(z), an RMSNorm
over the heads' width, and the output projection.  No FFN.  The input
is the token embedding times √d (√d rounded to bfloat16), the head the
tied embedding after a final RMSNorm; every RMSNorm scales by
(1 + scale).  Departures from the published model, which the served
model shares: the √d input factor and the (1 + scale) norms.

Nothing here reads the program: the parameters are the benchmark's own
tensors in the served tree's layout (``embed.table``, one stacked group
of ``mamba`` blocks, ``final_norm``), upcast a layer at a time.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .common import Precision, embed_scale, rmsnorm, silu


def _layer(stack, i: int):
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the positions: x (B, L, *ch), w
    (CW, *ch)."""
    cw, n = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0) * (x.dim() - 2) + (cw - 1, 0))
    return sum(xp[:, i:i + n] * w[i].to(torch.float32) for i in range(cw))


def _recurrence(x, dt, a, b, c):
    """The selective scan as its recurrence, one position after another:
    x (B, L, H, P), dt (B, L, H), a (H,), b, c (B, L, H, N) → y (B, L,
    H, P) without the skip term."""
    decay = torch.exp(dt * a)                                 # (B, L, H)
    state = x.new_zeros((x.shape[0], x.shape[2], x.shape[3], b.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        state = (state * decay[:, t, :, None, None]
                 + (dt[:, t, :, None] * x[:, t])[..., None]
                 * b[:, t, :, None, :])
        ys.append((state * c[:, t, :, None, :]).sum(-1))
    return torch.stack(ys, 1)


def chunked_scan(x, dt, a, b, c, chunk: int = 256):
    """The same scan in blocks of ``chunk`` positions (the SSD paper's
    block decomposition, for the backward pass): within a block the
    quadratic form Σ_{s≤q} (C_q · B_s) e^{Σ_{s<k≤q} dt_k a} dt_s x_s,
    across blocks the state entering each block, carried block by block.
    Shapes as ``_recurrence``'s."""
    bsz, n, h, hp = x.shape
    pad = (-n) % chunk
    if pad:             # dt = 0 past the end: no decay and no input
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc, ns = (n + pad) // chunk, b.shape[-1]
    xd = (x * dt[..., None]).reshape(bsz, nc, chunk, h, hp)
    bb = b.reshape(bsz, nc, chunk, h, ns)
    cc = c.reshape(bsz, nc, chunk, h, ns)
    cum = torch.cumsum((dt * a).reshape(bsz, nc, chunk, h), dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (b,c,q,s,h)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(causal, seg, -torch.inf))
    g = torch.einsum("bcqhn,bcshn->bcqsh", cc, bb) * decay
    y = torch.einsum("bcqsh,bcshp->bcqhp", g, xd)
    w = torch.exp(cum[:, :, -1:, :] - cum)                     # (b,c,s,h)
    states = torch.einsum("bcshn,bcshp->bchpn", bb * w[..., None], xd)
    carry = x.new_zeros((bsz, h, hp, ns))
    entering = []
    for i in range(nc):
        entering.append(carry)
        carry = carry * torch.exp(cum[:, i, -1, :])[..., None, None] \
            + states[:, i]
    entering = torch.stack(entering, dim=1)                   # (b,c,h,p,n)
    y = y + torch.einsum("bcqhn,bchpn->bcqhp", cc, entering) * torch.exp(
        cum)[..., None]
    return y.reshape(bsz, nc * chunk, h, hp)[:, :n]


def _block(p, u, m: Dict, prec: Precision, scan=_recurrence):
    bsz, n, _ = u.shape
    h = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    hp, g = m["ssm_head_dim"], m["ssm_n_groups"]
    z = prec.einsum("bld,dhp->blhp", u, p["wz"])
    x = prec.einsum("bld,dhp->blhp", u, p["wx"])
    b = prec.einsum("bld,dgn->blgn", u, p["wB"])
    c = prec.einsum("bld,dgn->blgn", u, p["wC"])
    dt = F.softplus(prec.einsum("bld,dh->blh", u, p["wdt"])
                    + p["dt_bias"].float())
    x = silu(_conv(x, p["conv_x"]))
    b = torch.repeat_interleave(silu(_conv(b, p["conv_B"])), h // g, dim=2)
    c = torch.repeat_interleave(silu(_conv(c, p["conv_C"])), h // g, dim=2)
    a = -torch.exp(p["A_log"].float())
    y = scan(x, dt, a, b, c) + p["D"].float()[None, None, :, None] * x
    y = (y * silu(z)).reshape(bsz, n, h * hp)
    y = rmsnorm(y, p["norm"]["scale"], m["norm_eps"])
    return prec.einsum("blhp,hpd->bld", y.reshape(bsz, n, h, hp),
                       p["out_proj"])


@torch.no_grad()
def logits(params, tokens: torch.Tensor, m: Dict, first: int,
           prefix: Optional[torch.Tensor] = None,
           prec: Precision = Precision()) -> torch.Tensor:
    """Logits (B, L − first, V), float32, at positions ``first`` … L − 1
    of ``tokens`` (B, L).  The model takes no prefix."""
    if prefix is not None:
        raise ValueError("a Mamba-2 language model takes no prefix")
    table = params["embed"]["table"]
    x = table[tokens].to(torch.float32) * embed_scale(m["d_model"])
    stack = params["groups"][0][0]
    for i in range(m["n_layers"]):
        p = _layer(stack, i)
        u = rmsnorm(x, p["norm_mix"]["scale"], m["norm_eps"])
        x = x + _block(p["mixer"], u, m, prec)
    x = rmsnorm(x[:, first:], params["final_norm"]["scale"], m["norm_eps"])
    return prec.einsum("bld,vd->blv", x, table)


def loss(params, tokens: torch.Tensor, labels: torch.Tensor, m: Dict,
         prec: Precision = Precision(), chunk: int = 256) -> torch.Tensor:
    """Mean next-token cross-entropy (float32) of ``tokens`` (B, L)
    against ``labels``, differentiable in ``params`` (float32 leaves);
    the scan in blocks, each layer recomputed in the backward pass."""
    from torch.utils.checkpoint import checkpoint
    table = params["embed"]["table"]
    x = table[tokens].to(torch.float32) * embed_scale(m["d_model"])
    stack = params["groups"][0][0]

    def layer(x, i):
        p = _layer(stack, i)
        u = rmsnorm(x, p["norm_mix"]["scale"], m["norm_eps"])
        return x + _block(p["mixer"], u, m, prec,
                          scan=lambda *a: chunked_scan(*a, chunk=chunk))

    for i in range(m["n_layers"]):
        x = checkpoint(layer, x, i, use_reentrant=False)
    x = rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])
    lg = prec.einsum("bld,vd->blv", x, table)
    return torch.nn.functional.cross_entropy(
        lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))
