"""Mamba2 (SSD) block for the zamba2 hybrid architecture (counterpart of
``repro/models/ssm.py``), plain PyTorch.

A prefill runs the chunked state-space-dual form: within a chunk a masked
quadratic form (matmuls), across chunks the state carried by a loop over
the chunks where the JAX package scans them. Decode is the O(1)-state
recurrence on one token; it writes the new conv and SSM state into the
layer's cache in place (the cache leaves are views of the model's stacked
cache), where the JAX function returns a new dict.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_norm, norm_decl
from repro_torch.parallel.sharding import ParamDecl

Tensor = torch.Tensor

SSD_CHUNK = 256


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm.expand * cfg.d_model
    n_heads = d_inner // cfg.ssm.headdim
    return d_inner, n_heads, cfg.ssm.headdim, cfg.ssm.state


def mamba2_decl(cfg: ModelConfig):
    d = cfg.d_model
    d_inner, nh, hd, st = _dims(cfg)
    conv_dim = d_inner + 2 * st                       # x, B, C go through the conv
    return {
        "norm": norm_decl(cfg),
        "in_proj": ParamDecl((d, 2 * d_inner + 2 * st + nh), ("embed", "inner")),
        "conv_w": ParamDecl((cfg.ssm.conv, conv_dim), (None, "inner")),
        "conv_b": ParamDecl((conv_dim,), ("inner",), init="zeros"),
        "a_log": ParamDecl((nh,), ("state_heads",), init="zeros"),
        "dt_bias": ParamDecl((nh,), ("state_heads",), init="zeros"),
        "d_skip": ParamDecl((nh,), ("state_heads",), init="ones"),
        "norm_gate": norm_decl(cfg, d_inner),
        "out_proj": ParamDecl((d_inner, d), ("inner", "embed_fsdp")),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor, state: Optional[Tensor] = None):
    """Depthwise causal conv1d. x: (B, S, C); w: (K, C); ``state`` the K-1
    inputs before x. Returns (y, new_state). The K products are summed in
    x's dtype in the JAX function's order (no ``conv1d``: its reduction
    order differs in 16 bits)."""
    k = w.shape[0]
    pad = state if state is not None else x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)                            # (B, S+K-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):]
    return F.silu((y + b).float()).to(x.dtype), new_state


def _split_proj(z_xbc_dt: Tensor, cfg: ModelConfig):
    d_inner, nh, hd, st = _dims(cfg)
    z = z_xbc_dt[..., :d_inner]
    xbc = z_xbc_dt[..., d_inner:2 * d_inner + 2 * st]
    dt = z_xbc_dt[..., 2 * d_inner + 2 * st:]
    return z, xbc, dt


def mamba2_block(p, x: Tensor, cfg: ModelConfig,
                 cache: Optional[dict] = None) -> Tuple[Tensor, Optional[dict]]:
    """x: (B, S, d) -> (residual delta, cache). With a cache (one token)
    ``conv`` and ``ssm`` are overwritten and ``pos`` advanced in place."""
    d_inner, nh, hd, st = _dims(cfg)
    dtype = x.dtype
    b, s, _ = x.shape

    xn = apply_norm(p["norm"], x, cfg)
    proj = torch.einsum("bsd,dk->bsk", xn, p["in_proj"].to(dtype))
    z, xbc, dt_raw = _split_proj(proj, cfg)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(dtype), p["conv_b"].to(dtype), conv_state)
    xs = xbc[..., :d_inner].reshape(b, s, nh, hd)
    b_in = xbc[..., d_inner:d_inner + st]                      # (B, S, st)
    c_in = xbc[..., d_inner + st:]                             # (B, S, st)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())     # (B, S, nh)
    a = -torch.exp(p["a_log"].float())                         # (nh,)
    log_decay = dt * a[None, None, :]                          # (B, S, nh)  <= 0

    if cache is None:
        y, _ = _ssd_chunked(xs, b_in, c_in, dt, log_decay, nh, hd, st, chunk=cfg.ssd_chunk)
    else:
        h0 = cache["ssm"]                                      # (B, nh, hd, st)
        decay = torch.exp(log_decay[:, 0])                     # (B, nh)
        dbx = torch.einsum("bn,bs,bnd->bnds", dt[:, 0], b_in[:, 0].float(), xs[:, 0].float())
        h1 = h0 * decay[..., None, None] + dbx
        y = torch.einsum("bs,bnds->bnd", c_in[:, 0].float(), h1).reshape(b, 1, nh, hd)
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(h1)
        cache["pos"].add_(s)

    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, s, d_inner).to(dtype)
    y = apply_norm(p["norm_gate"], y * F.silu(z.float()).to(dtype), cfg)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"].to(dtype))
    return out, cache


def _ssd_chunked(xs, b_in, c_in, dt, log_decay, nh, hd, st, chunk: int = SSD_CHUNK):
    """Chunked SSD: a loop over chunks, the quadratic form within each.

    xs: (B,S,nh,hd); b_in/c_in: (B,S,st); dt/log_decay: (B,S,nh).
    Returns y (B,S,nh,hd) fp32 and the final state (B,nh,hd,st)."""
    b, s = xs.shape[0], xs.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        b_in, c_in, dt, log_decay = (F.pad(t, (0, 0, 0, pad))
                                     for t in (b_in, c_in, dt, log_decay))
    nc = xs.shape[1] // chunk
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=xs.device).tril()

    h = torch.zeros((b, nh, hd, st), dtype=torch.float32, device=xs.device)
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xc, bc, cc, dtc, ldc = xs[:, sl], b_in[:, sl], c_in[:, sl], dt[:, sl], log_decay[:, sl]
        xcf, bcf, ccf = xc.float(), bc.float(), cc.float()
        cum = torch.cumsum(ldc, dim=1)                         # (B,C,nh) inclusive
        # intra-chunk quadratic form: L[i,j] = exp(cum_i - cum_j) * dt_j, i>=j
        li = cum[:, :, None, :] - cum[:, None, :, :]           # (B,C,C,nh)
        lmat = torch.where(mask[None, :, :, None], torch.exp(li), 0.0) * dtc[:, None, :, :]
        cb = torch.einsum("bis,bjs->bij", cc, bc).float()      # (B,C,C)
        y_intra = torch.einsum("bij,bijn,bjnd->bind", cb, lmat, xcf)
        # inter-chunk: the carried state's contribution
        y_inter = torch.einsum("bis,bnds,bin->bind", ccf, h, torch.exp(cum))
        # state update
        seg = torch.exp(cum[:, -1:, :] - cum)                  # decay from i to chunk end
        dbx = torch.einsum("bin,bis,bind->bnds", dtc * seg, bcf, xcf)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + dbx
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    return y, h


def mamba2_cache_decl(cfg: ModelConfig, batch: int):
    d_inner, nh, hd, st = _dims(cfg)
    conv_dim = d_inner + 2 * st
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    return {
        "conv": meta((batch, cfg.ssm.conv - 1, conv_dim), getattr(torch, cfg.dtype)),
        "ssm": meta((batch, nh, hd, st), torch.float32),
        "pos": meta((), torch.int32),
    }
