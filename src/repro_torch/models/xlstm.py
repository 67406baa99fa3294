"""xLSTM blocks (mLSTM + sLSTM) for the xlstm-350m architecture
(counterpart of ``repro/models/xlstm.py``), plain PyTorch.

* mLSTM: matrix-memory LSTM with exponential gating. A prefill runs the
  chunkwise-parallel stabilised form (matmuls within a chunk, O(1) state
  across chunks, a loop over the chunks where the JAX package scans them).
* sLSTM: scalar-memory LSTM with per-head recurrent weights: sequential by
  nature, a loop over time where the JAX package scans it.

Both blocks carry their own up/down projections (the config has
``d_ff = 0``: there is no separate MLP). With a cache (one token a step)
each block overwrites its state in the layer's cache in place, where the
JAX functions return a new dict.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_norm, norm_decl
from repro_torch.parallel.sharding import ParamDecl

Tensor = torch.Tensor

MLSTM_CHUNK = 256
MLSTM_EXPAND = 2
SLSTM_FF = 4 / 3


def _mdims(cfg: ModelConfig):
    d_inner = MLSTM_EXPAND * cfg.d_model
    nh = cfg.n_heads
    hd = d_inner // nh
    return d_inner, nh, hd


def mlstm_decl(cfg: ModelConfig):
    d = cfg.d_model
    d_inner, nh, hd = _mdims(cfg)
    return {
        "norm": norm_decl(cfg),
        "up_proj": ParamDecl((d, 2 * d_inner), ("embed", "inner")),
        "wq": ParamDecl((d_inner, d_inner), ("inner", None)),
        "wk": ParamDecl((d_inner, d_inner), ("inner", None)),
        "wv": ParamDecl((d_inner, d_inner), ("inner", None)),
        "w_if": ParamDecl((d_inner, 2 * nh), ("inner", None), scale=0.1),
        "b_if": ParamDecl((2 * nh,), (None,), init="zeros"),
        "norm_h": norm_decl(cfg, d_inner),
        "down_proj": ParamDecl((d_inner, d), ("inner", "embed_fsdp")),
    }


def mlstm_block(p, x: Tensor, cfg: ModelConfig,
                cache: Optional[dict] = None) -> Tuple[Tensor, Optional[dict]]:
    d_inner, nh, hd = _mdims(cfg)
    dtype = x.dtype
    b, s, _ = x.shape
    xn = apply_norm(p["norm"], x, cfg)
    up = torch.einsum("bsd,dk->bsk", xn, p["up_proj"].to(dtype))
    xin, z = up[..., :d_inner], up[..., d_inner:]
    proj = lambda w: torch.einsum("bsk,kj->bsj", xin, p[w].to(dtype)).reshape(b, s, nh, hd)
    q, k, v = proj("wq"), proj("wk"), proj("wv")
    gates = (torch.einsum("bsk,kj->bsj", xin, p["w_if"].to(dtype)).float()
             + p["b_if"].float())
    log_i = gates[..., :nh]                                    # pre-activation input gate
    log_f = F.logsigmoid(gates[..., nh:])                      # (B, S, nh) <= 0

    if cache is None:
        h, _, _, _ = _mlstm_chunked(q, k, v, log_i, log_f, nh, hd, chunk=cfg.ssd_chunk)
    else:
        c0, n0, m0 = cache["c"], cache["n"], cache["m"]        # (B,nh,hd,hd),(B,nh,hd),(B,nh)
        li, lf = log_i[:, 0], log_f[:, 0]                      # (B, nh)
        m1 = torch.maximum(lf + m0, li)
        fg = torch.exp(lf + m0 - m1)
        ig = torch.exp(li - m1)
        kf = k[:, 0].float() / np.sqrt(hd)
        c1 = c0 * fg[..., None, None] + ig[..., None, None] * torch.einsum(
            "bnd,bne->bnde", kf, v[:, 0].float())
        n1 = n0 * fg[..., None] + ig[..., None] * kf
        qf = q[:, 0].float()
        num = torch.einsum("bnd,bnde->bne", qf, c1)
        den = torch.maximum(torch.einsum("bnd,bnd->bn", qf, n1).abs(), torch.exp(-m1))
        h = (num / den[..., None])[:, None]                    # (B,1,nh,hd)
        cache["c"].copy_(c1)
        cache["n"].copy_(n1)
        cache["m"].copy_(m1)
        cache["pos"].add_(s)

    h = h.reshape(b, s, d_inner).to(dtype)
    h = apply_norm(p["norm_h"], h, cfg) * F.silu(z.float()).to(dtype)
    return torch.einsum("bsk,kd->bsd", h, p["down_proj"].to(dtype)), cache


def _mlstm_chunked(q, k, v, log_i, log_f, nh, hd, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel stabilised mLSTM. Shapes (B,S,nh,hd) / (B,S,nh).
    Returns (h, c, n, m): h (B,S,nh,hd) fp32 and the state after the last
    chunk."""
    b, s = q.shape[0], q.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_i = F.pad(log_i, (0, 0, 0, pad))
        log_f = F.pad(log_f, (0, 0, 0, pad), value=0.0)
    nc = q.shape[1] // chunk
    scale = 1.0 / np.sqrt(hd)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()

    c = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, nh, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, nh), -1e30, dtype=torch.float32, device=q.device)
    hs = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        qc = q[:, sl].float()
        kc = k[:, sl].float() * scale
        vc = v[:, sl].float()
        lic, lfc = log_i[:, sl], log_f[:, sl]
        cum_f = torch.cumsum(lfc, dim=1)                       # (B,C,nh) inclusive
        log_a = cum_f                                          # decay from chunk start to t
        # intra: D[i,j] = exp(cum_f_i - cum_f_j + li_j), j <= i; a masked
        # pair is -inf so that it weighs exactly 0
        dmat = cum_f[:, :, None, :] - cum_f[:, None, :, :] + lic[:, None, :, :]
        dmat = torch.where(mask[None, :, :, None], dmat, -torch.inf)
        m_intra = dmat.amax(dim=2)                             # (B,C,nh)
        m_inter = log_a + m[:, None, :]                        # carried max decayed
        m_new_t = torch.maximum(m_intra, m_inter)              # (B,C,nh) per-step stabiliser
        dw = torch.exp(dmat - m_new_t[:, :, None, :])          # (B,C,C,nh)
        sc = torch.einsum("bind,bjnd->bijn", qc, kc)
        num_intra = torch.einsum("bijn,bjne->bine", sc * dw, vc)
        # the denominator through the n vector (stabilised mLSTM)
        n_intra = torch.einsum("bijn,bjnd->bind", dw, kc)      # (B,C,nh,hd)
        inter_w = torch.exp(log_a + m[:, None, :] - m_new_t)   # (B,C,nh)
        num_inter = torch.einsum("bind,bnde->bine", qc, c) * inter_w[..., None]
        n_tot = n_intra + n[:, None] * inter_w[..., None]
        num = num_intra + num_inter
        den = torch.maximum(torch.einsum("bind,bind->bin", qc, n_tot).abs(),
                            torch.exp(-m_new_t))
        hs.append(num / den[..., None])                        # (B,C,nh,hd)

        # the state across the chunk boundary
        tot_f = cum_f[:, -1]                                   # (B,nh)
        m_next = torch.maximum(tot_f + m, (tot_f[:, None, :] - cum_f + lic).amax(dim=1))
        upd_w = torch.exp(tot_f[:, None, :] - cum_f + lic - m_next[:, None, :])  # (B,C,nh)
        carry = torch.exp(tot_f + m - m_next)
        c = c * carry[..., None, None] + torch.einsum("bin,bind,bine->bnde", upd_w, kc, vc)
        n = n * carry[..., None] + torch.einsum("bin,bind->bnd", upd_w, kc)
        m = m_next
    h = torch.cat(hs, dim=1)[:, :s]
    return h, c, n, m


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_decl(cfg: ModelConfig):
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    f = int(SLSTM_FF * d) // 128 * 128 or int(SLSTM_FF * d)
    return {
        "norm": norm_decl(cfg),
        "w_in": ParamDecl((d, 4 * d), ("embed", "inner")),       # i, f, z, o pre-acts
        "r": ParamDecl((nh, hd, 4 * hd), ("state_heads", None, None), scale=0.5 / np.sqrt(hd)),
        "b": ParamDecl((4 * d,), (None,), init="zeros"),
        "norm_h": norm_decl(cfg, d),
        "ff_norm": norm_decl(cfg),
        "ff_up": ParamDecl((d, 2 * f), ("embed", "ff")),
        "ff_down": ParamDecl((f, d), ("ff", "embed_fsdp")),
    }


def _slstm_step(p_r, carry, gates_x, nh, hd):
    """One sLSTM time step. gates_x: (B, 4d) input contribution; carry
    (c, n, h, m), each (B, nh, hd). Returns the new carry."""
    c, n, h, m = carry
    b = gates_x.shape[0]
    rec = torch.einsum("bnd,ndk->bnk", h, p_r)                 # (B, nh, 4hd)
    gx = gates_x.reshape(b, nh, 4 * hd) + rec
    li, lf, z, o = gx.split(hd, dim=-1)                        # (B, nh, hd)
    log_fg = F.logsigmoid(lf)
    m_new = torch.maximum(log_fg + m, li)
    ig = torch.exp(li - m_new)
    fg = torch.exp(log_fg + m - m_new)
    c_new = fg * c + ig * torch.tanh(z)
    n_new = torch.clamp(fg * n + ig, min=1e-6)
    h_new = torch.sigmoid(o) * c_new / n_new
    return (c_new, n_new, h_new, m_new)


def slstm_block(p, x: Tensor, cfg: ModelConfig,
                cache: Optional[dict] = None) -> Tuple[Tensor, Optional[dict]]:
    """A prefill steps through time on the host, S steps of a few small
    launches each; with a cache (one token) ``c``, ``n``, ``h``, ``m`` are
    overwritten and ``pos`` advanced in place."""
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dtype = x.dtype
    b, s, _ = x.shape
    xn = apply_norm(p["norm"], x, cfg)
    gates_x = torch.einsum("bsd,dk->bsk", xn, p["w_in"].to(dtype)).float() + p["b"].float()
    p_r = p["r"].float()

    if cache is None:
        zeros = lambda: torch.zeros((b, nh, hd), dtype=torch.float32, device=x.device)
        carry = (zeros(), zeros(), zeros(),
                 torch.full((b, nh, hd), -1e30, dtype=torch.float32, device=x.device))
        hs = []
        for t in range(s):
            carry = _slstm_step(p_r, carry, gates_x[:, t], nh, hd)
            hs.append(carry[2])
        h = torch.stack(hs, dim=1)                             # (B, S, nh, hd)
    else:
        carry = (cache["c"], cache["n"], cache["h"], cache["m"])
        new = _slstm_step(p_r, carry, gates_x[:, 0], nh, hd)
        h = new[2][:, None]
        for name, t in zip(("c", "n", "h", "m"), new):
            cache[name].copy_(t)
        cache["pos"].add_(s)

    h = h.reshape(b, s, d).to(dtype)
    y = apply_norm(p["norm_h"], h, cfg)
    # GEGLU feed-forward (the sLSTM block's own FF, d_ff = 4/3 d); JAX's
    # gelu is the tanh form by default
    yn = apply_norm(p["ff_norm"], x + y, cfg)
    up = torch.einsum("bsd,dk->bsk", yn, p["ff_up"].to(dtype))
    f = up.shape[-1] // 2
    act = F.gelu(up[..., :f].float(), approximate="tanh").to(dtype) * up[..., f:]
    ff = torch.einsum("bsf,fd->bsd", act, p["ff_down"].to(dtype))
    return y + ff, cache
