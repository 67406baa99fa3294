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
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_norm, norm_decl
from repro_torch.parallel.sharding import (ParamDecl, on_local_rows, replicate,
                                          whole_over_model)

Tensor = torch.Tensor

MLSTM_CHUNK = 256
MLSTM_EXPAND = 2
SLSTM_FF = 4 / 3


def _log_sigmoid(x: Tensor) -> Tensor:
    """``F.logsigmoid``; on a DTensor in the form of PyTorch's CPU kernel,
    ``min(x, 0) - log1p(exp(-|x|))``, from ops that DTensor shards (it has
    no rule for ``log_sigmoid_forward``)."""
    if not isinstance(x, DTensor):
        return F.logsigmoid(x)
    return torch.clamp(x, max=0) - torch.log1p(torch.exp(-x.abs()))


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
    # whole over model before the split: its halves do not fall on the shards
    up = whole_over_model(torch.einsum("bsd,dk->bsk", xn, p["up_proj"].to(dtype)))
    xin, z = up[..., :d_inner], up[..., d_inner:]
    proj = lambda w: torch.einsum("bsk,kj->bsj", xin, p[w].to(dtype)).reshape(b, s, nh, hd)
    q, k, v = proj("wq"), proj("wk"), proj("wv")
    # the gate weight (d_inner, 2 nh) whole over model: its two nh-wide
    # halves are cut from the gates, which a partial sum would leave strided
    gates = (torch.einsum("bsk,kj->bsj", xin, replicate(p["w_if"]).to(dtype)).float()
             + p["b_if"].float())
    log_i = gates[..., :nh]                                    # pre-activation input gate
    log_f = _log_sigmoid(gates[..., nh:])                      # (B, S, nh) <= 0

    if cache is None and isinstance(q, DTensor):
        # each rank's rows and heads
        h, = on_local_rows(
            lambda *t: _mlstm_chunked(*t, None, hd, chunk=cfg.ssd_chunk)[:1],
            (q, k, v, log_i, log_f), (2, 2, 2, 2, 2), (2,), nh)
    elif cache is None:
        h, _, _, _ = _mlstm_chunked(q, k, v, log_i, log_f, nh, hd, chunk=cfg.ssd_chunk)
    else:
        run = lambda *t: _mlstm_decode(*t, hd)
        args = (q, k, v, log_i, log_f, cache["c"], cache["n"], cache["m"])
        if isinstance(q, DTensor):
            # under a mesh each rank's rows, the state whole over model
            h, c1, n1, m1 = on_local_rows(run, args, (None,) * 8, (None,) * 4, nh)
        else:
            h, c1, n1, m1 = run(*args)
        cache["c"].copy_(c1)
        cache["n"].copy_(n1)
        cache["m"].copy_(m1)
        cache["pos"].add_(s)

    # whole over model for the norm over the inner width (heads split over
    # model leave each rank a slice of it)
    h = whole_over_model(h.reshape(b, s, d_inner)).to(dtype)
    h = apply_norm(p["norm_h"], h, cfg) * F.silu(z.float()).to(dtype)
    # the inner width's partial sums reduced once, to the residual's layout
    return whole_over_model(torch.einsum("bsk,kd->bsd", h, p["down_proj"].to(dtype))), cache


def _mlstm_decode(q, k, v, log_i, log_f, c0, n0, m0, hd: int):
    """One mLSTM step from the state (c0, n0, m0): (B,nh,hd,hd), (B,nh,hd),
    (B,nh). Returns (h (B,1,nh,hd), c1, n1, m1)."""
    li, lf = log_i[:, 0], log_f[:, 0]                          # (B, nh)
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
    return (num / den[..., None])[:, None], c1, n1, m1         # h (B,1,nh,hd)


def _mlstm_chunked(q, k, v, log_i, log_f, nh, hd, chunk: int = MLSTM_CHUNK):
    """Chunkwise-parallel stabilised mLSTM. Shapes (B,S,nh,hd) / (B,S,nh).
    Returns (h, c, n, m): h (B,S,nh,hd) fp32 and the state after the last
    chunk."""
    b, s, nh = q.shape[0], q.shape[1], q.shape[2]
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
    log_fg = _log_sigmoid(lf)
    m_new = torch.maximum(log_fg + m, li)
    ig = torch.exp(li - m_new)
    fg = torch.exp(log_fg + m - m_new)
    c_new = fg * c + ig * torch.tanh(z)
    n_new = torch.clamp(fg * n + ig, min=1e-6)
    h_new = torch.sigmoid(o) * c_new / n_new
    return (c_new, n_new, h_new, m_new)


def _initial_carry(b: int, nh: int, hd: int, device):
    zeros = lambda: torch.zeros((b, nh, hd), dtype=torch.float32, device=device)
    return (zeros(), zeros(), zeros(),
            torch.full((b, nh, hd), -1e30, dtype=torch.float32, device=device))


def _slstm_time(p_r, gates_x, nh: int, hd: int, *carry):
    """The time loop over ``gates_x`` (B, S, 4d): (h (B, S, nh, hd),) from
    the initial carry, or (h, c, n, h, m) from a cache's ``carry``."""
    b, s = gates_x.shape[:2]
    state = carry or _initial_carry(b, nh, hd, gates_x.device)
    hs = []
    for t in range(s):
        state = _slstm_step(p_r, state, gates_x[:, t], nh, hd)
        hs.append(state[2])
    h = torch.stack(hs, dim=1)                                 # (B, S, nh, hd)
    return (h, *state) if carry else (h,)


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
    state = () if cache is None else tuple(cache[name] for name in ("c", "n", "h", "m"))
    run = lambda g, r, *carry: _slstm_time(r, g, nh, hd, *carry)
    if isinstance(gates_x, DTensor):
        # under a mesh each rank's rows, whole over model: a model axis wider
        # than the heads cannot hold a head a rank
        out = on_local_rows(run, (gates_x, p_r) + state, (None,) * (2 + len(state)),
                            (None,) * (1 + len(state)), nh, row_dims=(0, None) + (0,) * len(state))
    else:
        out = run(gates_x, p_r, *state)
    h = out[0]
    for name, t in zip(("c", "n", "h", "m"), out[1:]):         # a cache's new state, in place
        cache[name].copy_(t)
    if cache is not None:
        cache["pos"].add_(s)

    h = h.reshape(b, s, d).to(dtype)
    y = apply_norm(p["norm_h"], h, cfg)
    # GEGLU feed-forward (the sLSTM block's own FF, d_ff = 4/3 d); JAX's
    # gelu is the tanh form by default
    yn = apply_norm(p["ff_norm"], x + y, cfg)
    up = whole_over_model(torch.einsum("bsd,dk->bsk", yn, p["ff_up"].to(dtype)))
    f = up.shape[-1] // 2
    act = F.gelu(up[..., :f].float(), approximate="tanh").to(dtype) * up[..., f:]
    ff = whole_over_model(torch.einsum("bsf,fd->bsd", act, p["ff_down"].to(dtype)))
    return y + ff, cache
