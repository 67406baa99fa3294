"""Core neural layers, functional PyTorch (counterpart of
``repro/models/layers.py``).

Attention takes one of two routes, chosen by the call's shape and never by
catching an error (:func:`multihead_attention`): inside B11's contract
(self-attention, causal, no window, ``q_offset == 0``, ``S == T``, a head
width that is a multiple of 8 up to 256, no ``probs_bf16``) it goes through
the B11 door ``repro_torch.kernels.ops.flash_attention`` — the Hopper kernel
for a CUDA tensor, its plain version for a CPU one; every other call
(sliding window, cross-attention, the ``probs_bf16`` lever) runs the JAX
package's triangular block schedule in plain PyTorch. A launch of B11 that
fails raises.

The B11 route is differentiable through :class:`_B11Attention`: the kernel
carries the forward, and the backward is the gradient of the JAX package's
own function, the triangular block schedule, recomputed from the saved q, k
and v. The kernel's output has no autograd history (a ``ctypes`` launch
fills it), and the door refuses to run under grad, so no caller can cut the
gradient of q, k and v silently.

Under a mesh (:func:`repro_torch.parallel.sharding.set_mesh`) the
activations and parameters are DTensors. :func:`multihead_attention` takes
the JAX function's ``tp > 1`` branches (kv heads repeated to the q heads
when only the q heads divide TP, heads zero-padded to a TP multiple under
``pad_heads``, else the head dimension sharded, and the ``constrain``
anchors); on B11's route with whole head dims each rank runs B11 on its
own heads (:func:`_b11_sharded`: the door takes plain contiguous tensors),
and the head-dim fallback takes the block schedule on the DTensors. A
decode step over a time-sharded cache (``launch.steps.cache_shardings``) is
:func:`_decode_sharded`: the rank whose time shard holds the slot writes
it, and each rank's partial softmax over its shard is combined across the
shards (flash-decoding). The JAX compile lever ``unroll`` has no port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import ParamDecl, constrain, redistribute, settle, tp_size

Tensor = torch.Tensor

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_decl(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {
            "scale": ParamDecl((d,), ("embed",), init="ones"),
            "bias": ParamDecl((d,), ("embed",), init="zeros"),
        }
    return {"scale": ParamDecl((d,), ("embed",), init="ones")}


def apply_norm(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Stats in fp32, elementwise math in the activation dtype (the JAX
    package's mixed-precision form)."""
    if cfg.norm == "layernorm":
        mu = x.mean(-1, keepdim=True, dtype=torch.float32)
        var = (x.float() - mu).square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + 1e-5).to(x.dtype)
        return (x - mu.to(x.dtype)) * inv * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    var = x.square().mean(-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + 1e-6).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (with partial-rotary support for stablelm-2)
# ---------------------------------------------------------------------------

def apply_rope(x: Tensor, positions: Tensor, theta: float, pct: float = 1.0) -> Tensor:
    """x: (..., S, H, hd); positions: (..., S) integers."""
    hd = x.shape[-1]
    rot = int(hd * pct) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    exps = -torch.arange(0, rot, 2, dtype=torch.float32, device=x.device) / rot
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., None].to(torch.float32) * freqs              # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                                 # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(yr.dtype)], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention: declarations
# ---------------------------------------------------------------------------

def attention_decl(cfg: ModelConfig, cross: bool = False):
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd()
    decl = {
        "wq": ParamDecl((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDecl((d, k, hd), ("embed", "kv_heads", None)),
        "wv": ParamDecl((d, k, hd), ("embed", "kv_heads", None)),
        "wo": ParamDecl((h, hd, d), ("heads", None, "embed_fsdp")),
        "norm": norm_decl(cfg),
    }
    if cross:
        decl["norm_kv"] = norm_decl(cfg)
    return decl


# ---------------------------------------------------------------------------
# Attention: the B11 route and the plain triangular block schedule
# ---------------------------------------------------------------------------

def _block_pairs(n_q: int, n_kv: int, causal: bool, window_chunks: Optional[int]):
    """Static schedule of visible (q_chunk, kv_chunk) pairs."""
    pairs = []
    for qi in range(n_q):
        for kj in range(n_kv):
            if causal and kj > qi:
                continue
            if window_chunks is not None and kj < qi - window_chunks:
                continue
            pairs.append((qi, kj))
    return np.array(pairs, dtype=np.int32).reshape(-1, 2)


def b11_route(q: Tensor, k: Tensor, *, causal: bool, window: Optional[int], q_offset: int,
              probs_bf16: bool) -> bool:
    """Whether a :func:`multihead_attention` call lies inside B11's
    contract and goes through the kernel door."""
    hd = q.shape[-1]
    return (causal and window is None and q_offset == 0 and q.shape[1] == k.shape[1]
            and hd % 8 == 0 and hd <= _fa.MAX_HEAD_DIM and not probs_bf16
            and q.dtype in _fa.DTYPES)


def _attention_b11(q: Tensor, k: Tensor, v: Tensor, backend: str) -> Tensor:
    """Causal self-attention through the B11 door: kv heads repeated to the
    q heads (q head h reads kv head h // g, the JAX grouping), batch and
    heads folded into (B·H, S, hd). The door's blocks divide S (256 where
    they can, else S itself); on the card they change nothing but the
    order of rounding."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    # contiguous: at b = 1 the reshape is a strided view, which the kernel refuses
    fold = lambda x: x.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    blk = 256 if s % 256 == 0 else s
    attend = kops.flash_attention if backend == "cuda" else _fa.flash_attention_plain
    out = attend(fold(q), fold(k), fold(v), True, blk, blk)
    return out.view(b, h, s, hd).transpose(1, 2)


def _b11_backward(q: Tensor, k: Tensor, v: Tensor, grad: Tensor, chunk: int):
    """The gradients of q, k and v: autograd of :func:`_attention_blocks`
    (causal, no window, ``q_offset`` 0, chunks of ``chunk``), the function
    JAX differentiates, recomputed from the saved inputs."""
    with torch.enable_grad():
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out = _attention_blocks(q, k, v, causal=True, chunk=chunk, window=None, q_offset=0,
                                probs_bf16=False)
        return torch.autograd.grad(out, (q, k, v), grad)


class _B11Attention(torch.autograd.Function):
    """Causal self-attention inside B11's contract: the forward is
    :func:`_attention_b11` (the kernel door on ``cuda``, its plain version on
    any other backend) and saves q, k and v, not the probabilities; the
    backward is :func:`_b11_backward`. There is no backward kernel: the JAX
    package has none either, and its gradient is that of the block
    schedule."""

    @staticmethod
    def forward(ctx, q, k, v, backend: str, chunk: int):
        ctx.save_for_backward(q, k, v)
        ctx.chunk = chunk
        return _attention_b11(q, k, v, backend)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        return (*_b11_backward(q, k, v, grad, ctx.chunk), None, None)


def _attention_blocks(q, k, v, *, causal, chunk, window, q_offset, probs_bf16) -> Tensor:
    """The JAX function's chunked online softmax over its static schedule of
    visible (q chunk, kv chunk) pairs, in plain PyTorch; the state is kept
    per q chunk, which visits its kv chunks in the schedule's order."""
    b, s, h, hd = q.shape
    t, n_kv_heads = k.shape[1], k.shape[2]
    g = h // n_kv_heads
    chunk = min(chunk, s, t)
    s_pad, t_pad = (-s) % chunk, (-t) % chunk
    qp = F.pad(q, (0, 0, 0, 0, 0, s_pad))
    kp = F.pad(k, (0, 0, 0, 0, 0, t_pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, t_pad))
    n_q, n_kv = qp.shape[1] // chunk, kp.shape[1] // chunk
    window_chunks = None if window is None else (window + chunk - 1) // chunk + 1
    pairs = _block_pairs(n_q, n_kv, causal, window_chunks)

    qp = qp.view(b, n_q, chunk, n_kv_heads, g, hd)
    kp = kp.view(b, n_kv, chunk, n_kv_heads, hd)
    vp = vp.view(b, n_kv, chunk, n_kv_heads, hd)
    scale = 1.0 / np.sqrt(hd)
    pos = torch.arange(max(n_q, n_kv) * chunk, device=q.device)
    outs = []                      # a q chunk's output each (a list: DTensors take no setitem)
    for qi in range(n_q):
        kjs = pairs[pairs[:, 0] == qi, 1]
        acc = torch.zeros((b, n_kv_heads, g, chunk, hd), dtype=torch.float32, device=q.device)
        if not len(kjs):
            outs.append(acc)
            continue
        m = torch.full((b, n_kv_heads, g, chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        qpos = q_offset + pos[qi * chunk:(qi + 1) * chunk]
        for kj in kjs.tolist():
            kpos = pos[kj * chunk:(kj + 1) * chunk]
            vc = vp[:, kj]
            scores = torch.einsum("bikgd,bjkd->bkgij", qp[:, qi], kp[:, kj]).float() * scale
            mask = (kpos < t)[None, :]                                   # kv padding
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            scores = torch.where(mask, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            if probs_bf16:
                dt = torch.promote_types(torch.bfloat16, vc.dtype)
                pv = torch.einsum("bkgij,bjkd->bkgid", p.to(torch.bfloat16).to(dt),
                                  vc.to(dt)).float()
            else:
                pv = torch.einsum("bkgij,bjkd->bkgid", p, vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=1).permute(0, 1, 4, 2, 3, 5).reshape(b, n_q * chunk, h, hd)
    return out[:, :s].to(q.dtype)


def _b11_sharded(q: Tensor, k: Tensor, v: Tensor, backend: str, chunk: int) -> Tensor:
    """B11 on each rank's shard of DTensor q, k and v whose time and head
    dimensions are whole on every rank (batch and heads may be sharded): q
    and v laid out as k (q head h stays with kv head h // g), then
    :class:`_B11Attention` on the local tensors — the door's ``ctypes``
    launch takes plain contiguous tensors — and the result wrapped back."""
    want = tuple(k.placements)
    q, v = (x if tuple(x.placements) == want else redistribute(x, want) for x in (q, v))
    out = _B11Attention.apply(q.to_local(), k.to_local(), v.to_local(), backend, chunk)
    return DTensor.from_local(out, k.device_mesh, want, run_check=False)


def _whole_rows(x: Tensor) -> bool:
    """Whether a DTensor (B, S, H, hd) holds whole sequences and head dims
    on every rank (only batch and heads sharded, nothing partial)."""
    return all(not p.is_partial() and not (p.is_shard() and p.dim in (1, 3))
               for p in x.placements)


def multihead_attention(
    q: Tensor,                   # (B, S, H, hd)
    k: Tensor,                   # (B, T, K, hd)
    v: Tensor,                   # (B, T, K, hd)
    *,
    causal: bool,
    chunk: int = 1024,
    window: Optional[int] = None,
    q_offset: int = 0,
    probs_bf16: bool = False,
    pad_heads: bool = False,
    backend: str = "cuda",
) -> Tensor:
    """Online-softmax attention; GQA: H a multiple of K. ``window`` masks
    to a sliding window (h2o-danube). Returns (B, S, H, hd).

    A call inside B11's contract (:func:`b11_route`) goes through the
    kernel door on the ``cuda`` backend and through the kernel's plain
    version ``flash_attention_plain`` on any other (the same online
    softmax), by :class:`_B11Attention`, whose backward is the block
    schedule's gradient; every other call runs the JAX package's
    triangular block schedule (chunks of ``chunk``) in plain PyTorch.

    Under a mesh whose ``model`` axis is wider than 1 (``tp > 1``) the JAX
    function's layout comes first: kv heads repeated to the q heads when
    the kv count does not divide TP but the q count does; with
    ``pad_heads``, heads zero-padded to the next TP multiple (padded heads
    attend uniformly and are cut before the output projection); else the
    head dimension sharded over ``model``. On B11's route with whole head
    dimensions q's heads follow k's (JAX leaves them unanchored when g > 1;
    the layout changes no value) and each rank runs B11 on its own heads."""
    b, s, h, hd = q.shape
    n_kv_heads = k.shape[2]
    g = h // n_kv_heads
    route = b11_route(q, k, causal=causal, window=window, q_offset=q_offset,
                      probs_bf16=probs_bf16)
    tp = tp_size()
    h_orig = h
    if tp > 1:
        if n_kv_heads % tp != 0 and h % tp == 0 and g > 1:
            k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
            n_kv_heads, g = h, 1
        if pad_heads and n_kv_heads % tp != 0:
            # zero-pad heads to the next TP multiple: padded heads attend
            # uniformly over valid kv (scores 0), and their outputs are cut
            # before the output projection
            if g > 1:
                k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
                n_kv_heads, g = h, 1
            hp = -(-h // tp) * tp
            q, k, v = (F.pad(x, (0, 0, 0, hp - h)) for x in (q, k, v))
            h = n_kv_heads = hp
        head_entry = "model" if n_kv_heads % tp == 0 else None
        hd_entry = None if head_entry else "model"
        q_entry = head_entry if g == 1 or (route and hd_entry is None) else None
        q = constrain(q, "dp", None, q_entry, hd_entry)
        k = constrain(k, "dp", None, head_entry, hd_entry)
        v = constrain(v, "dp", None, head_entry, hd_entry)

    sharded = isinstance(k, DTensor)
    if route and sharded and all(map(_whole_rows, (q, k, v))):
        out = _b11_sharded(q, k, v, backend, chunk)
    elif route and not sharded:
        out = _B11Attention.apply(q, k, v, backend, chunk)
    else:                          # outside B11's contract, or the head-dim fallback
        out = _attention_blocks(q, k, v, causal=causal, chunk=chunk, window=window,
                                q_offset=q_offset, probs_bf16=probs_bf16)
    return out if h == h_orig else out[:, :, :h_orig]


def decode_attention(
    q: Tensor,                   # (B, 1, H, hd)
    k_cache: Tensor,             # (B, T, K, hd)  (already roped)
    v_cache: Tensor,             # (B, T, K, hd)
    kv_positions: Tensor,        # (T,) or (B, T) absolute positions, -1 = invalid
    q_position: Tensor,          # scalar — position of the new token
    *,
    window: Optional[int] = None,
) -> Tensor:
    """Single-token attention over a (ring-buffered) cache, plain PyTorch."""
    b, _, h, hd = q.shape
    n_kv_heads = k_cache.shape[2]
    g = h // n_kv_heads
    qg = q.reshape(b, 1, n_kv_heads, g, hd)
    scores = torch.einsum("bikgd,bjkd->bkgj", qg, k_cache).float() / np.sqrt(hd)
    if kv_positions.dim() == 1:
        kv_positions = kv_positions[None, :]
    valid = (kv_positions >= 0) & (kv_positions <= q_position)
    if window is not None:
        valid = valid & (q_position - kv_positions < window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgj,bjkd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _decode_sharded(q: Tensor, k: Tensor, v: Tensor, cache: dict, positions: Tensor,
                    window: Optional[int]) -> Tensor:
    """One decode step over a layer's cache whose K/V are DTensors sharded
    over time (``cache_shardings``: batch over the data axes where it
    divides, time over ``model``): q, k and v are made whole in heads and
    laid out as the cache's batch; the rank whose time shard holds the slot
    writes the new K/V (the others keep theirs), every rank writes the
    replicated positions and ``pos``; then each rank's partial softmax
    over its time shard (max, sum, weighted values) is combined by
    all-reduces over the time groups — the result of
    :func:`decode_attention` over the whole cache."""
    if k.shape[1] != 1:
        raise ValueError(f"a time-sharded cache takes one token a step, not {k.shape[1]}")
    ck_d = cache["k"]
    mesh, kp = ck_d.device_mesh, tuple(ck_d.placements)
    want = tuple(p if p.is_shard() and p.dim == 0 else Replicate() for p in kp)
    q_l, k_l, v_l = (redistribute(x, want).to_local() for x in (q, k, v))
    ck, cv = ck_d.to_local(), cache["v"].to_local()
    kv_pos, pos = cache["positions"].to_local(), cache["pos"].to_local()
    size, t_loc = ck_d.shape[1], ck.shape[1]
    t_dims = [i for i, p in enumerate(kp) if p.is_shard() and p.dim == 1]
    coord, index = mesh.get_coordinate(), 0
    for i in t_dims:
        index = index * mesh.shape[i] + coord[i]
    off = index * t_loc
    slot = pos % size if window is not None else pos
    idx = slot.clamp(max=size - 1).long().reshape(1)
    li = idx - off
    inside = (li >= 0) & (li < t_loc)
    lic = li.clamp(0, t_loc - 1)
    for c, new in ((ck, k_l), (cv, v_l)):
        c.index_copy_(1, lic, torch.where(inside[None, :, None, None], new, c.index_select(1, lic)))
    kv_pos.index_copy_(0, idx, positions.to(torch.int32))
    pos.add_(1)

    b, _, h, hd = q_l.shape
    n_kv_heads = ck.shape[2]
    g = h // n_kv_heads
    qg = q_l.reshape(b, 1, n_kv_heads, g, hd)
    scores = torch.einsum("bikgd,bjkd->bkgj", qg, ck).float() / np.sqrt(hd)
    mine = kv_pos[off:off + t_loc][None, :]
    valid = (mine >= 0) & (mine <= positions[0])
    if window is not None:
        valid = valid & (positions[0] - mine < window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(-1)
    groups = [mesh.get_group(i) for i in t_dims]
    for grp in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bkgj,bjkd->bkgd", p, cv.float())
    for grp in groups:
        dist.all_reduce(l, group=grp)
        dist.all_reduce(acc, group=grp)
    out = (acc / l[..., None]).reshape(b, 1, h, hd).to(q_l.dtype)
    return DTensor.from_local(out, mesh, want, run_check=False)


def _write_cache(cache: dict, k: Tensor, v: Tensor, positions: Tensor, window) -> None:
    """Append this step's K/V and positions to a layer's cache in place, at
    ``pos`` (ring: ``pos mod size``) clamped so the slice fits, as
    ``dynamic_update_slice`` clamps; then advance ``pos``."""
    size, s = cache["k"].shape[1], k.shape[1]
    slot = cache["pos"] % size if window is not None else cache["pos"]
    idx = slot.clamp(max=size - s).long() + torch.arange(s, device=k.device)
    cache["k"].index_copy_(1, idx, k)
    cache["v"].index_copy_(1, idx, v)
    cache["positions"].index_copy_(0, idx, positions.to(torch.int32))
    cache["pos"].add_(s)


def attention_block(
    p,
    x: Tensor,                   # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: Tensor,           # (S,) absolute positions of x
    kv_src: Optional[Tensor] = None,   # cross-attention source (B, Skv, d)
    cache: Optional[dict] = None,      # decode cache for this layer
    window: Optional[int] = None,
    cross: bool = False,
    backend: str = "cuda",
) -> Tuple[Tensor, Optional[dict]]:
    """Pre-norm attention block: returns (residual delta, cache).

    ``cross=True`` attends to ``kv_src`` (or, during decode, to the
    precomputed K/V held in ``cache``) with no causal mask. A self-attention
    cache (one token a step) is updated in place and returned, where the
    JAX function returns a new one."""
    dtype = x.dtype
    xn = apply_norm(p["norm"], x, cfg)
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"].to(dtype))
    if cross and cache is not None:
        k = v = None                      # K/V precomputed in the cache
    else:
        src = apply_norm(p["norm_kv"], kv_src, cfg) if cross else xn
        k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(dtype))
        v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(dtype))

    if not cross:
        q = apply_rope(q, positions[None, :], cfg.rope_theta, cfg.rope_pct)
        k = apply_rope(k, positions[None, :], cfg.rope_theta, cfg.rope_pct)

    attend = dict(chunk=cfg.attn_chunk, probs_bf16=cfg.attn_probs_bf16,
                  pad_heads=cfg.pad_attn_heads, backend=backend)
    if cache is not None and not cross and isinstance(cache["k"], DTensor):
        out = _decode_sharded(q, k, v, cache, positions, window)
    elif cache is not None and not cross:
        _write_cache(cache, k, v, positions, window)
        out = decode_attention(q, cache["k"], cache["v"], cache["positions"], positions[0],
                               window=window)
    elif cache is not None:
        out = multihead_attention(q, cache["k"], cache["v"], causal=False, **attend)
    else:
        out = multihead_attention(q, k, v, causal=not cross, window=window, q_offset=0,
                                  **attend)
        cache = None
    # the heads' partial sums reduced once, to the residual's layout
    y = settle(torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dtype)))
    return y, cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_decl(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": norm_decl(cfg),
        "w_gate": ParamDecl((d, f), ("embed", "ff")),
        "w_up": ParamDecl((d, f), ("embed", "ff")),
        "w_down": ParamDecl((f, d), ("ff", "embed_fsdp")),
    }


def mlp_block(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    dtype = x.dtype
    xn = apply_norm(p["norm"], x, cfg)
    gate = torch.einsum("bsd,df->bsf", xn, p["w_gate"].to(dtype))
    up = torch.einsum("bsd,df->bsf", xn, p["w_up"].to(dtype))
    act = F.silu(gate.float()).to(dtype) * up
    return settle(torch.einsum("bsf,fd->bsd", act, p["w_down"].to(dtype)))


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_decl(cfg: ModelConfig):
    decl = {}
    vp = cfg.padded_vocab()
    if not cfg.embed_frontend_stub:
        decl["tok"] = ParamDecl((vp, cfg.d_model), ("vocab", "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        decl["head"] = ParamDecl((cfg.d_model, vp), ("embed", "vocab"))
    decl["norm_f"] = norm_decl(cfg)
    return decl


def embed_tokens(p, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """The token table's rows; on a vocab-sharded table (a DTensor) each
    rank looks up the rows it holds and the partial rows are summed once
    (:func:`settle`)."""
    return settle(F.embedding(tokens.long(), p["tok"]).to(_dt(cfg)))


def lm_head(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Final norm + projection to vocab. x: (B, S, d) -> (B, S, V_padded)."""
    xn = apply_norm(p["norm_f"], x, cfg)
    w = (p["tok"].t() if cfg.tie_embeddings else p["head"]).to(x.dtype)
    logits = torch.einsum("bsd,dv->bsv", xn, w)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    vp = cfg.padded_vocab()
    if vp != cfg.vocab:
        # mask padded vocab columns so they never win softmax/argmax
        col = torch.arange(vp, device=x.device)
        logits = torch.where(col < cfg.vocab, logits,
                             torch.tensor(-1e9, dtype=logits.dtype, device=x.device))
    return logits


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)
