"""Plain-torch oracles of the kernels (counterpart of ``repro/kernels/ref.py``).

Each function states one kernel contract in the most direct form, one-hot
masks and cumulative sums, written apart from the plain versions of
:mod:`repro_torch.kernels.common` so that the two can be held against each
other and against the JAX oracles. Integer outputs are int32 and must
match bitwise. Ids lie in ``[0, m)``: for an id outside, the one-hot form
gives destination 0, as the JAX oracle does (ROADMAP §C 3), where the
kernels clamp it into a bucket.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _one_hot(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    """(L, T) ids -> (L, T, m) int64 one-hot."""
    return (ids_tiled[..., None] == torch.arange(num_buckets, device=ids_tiled.device)).long()


def _scatter_rows(dest: Tensor, x: Tensor) -> Tensor:
    """``out[l, dest[l, t]] = x[l, t]`` on the 32-bit words of ``x``."""
    words = x.view(torch.int32)
    return torch.zeros_like(words).scatter_(1, dest.long(), words).view(x.dtype)


def _digits(keys_tiled: Tensor, shift: int, bits: int) -> Tensor:
    """``(u >> shift) & (2^bits - 1)`` of the keys' 32-bit words, as int32."""
    u = keys_tiled.view(torch.int32).long() & 0xFFFFFFFF
    return ((u >> shift) & ((1 << bits) - 1)).to(torch.int32)


def tile_histograms(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    """(L, T) int32 bucket ids -> (L, m) int32 per-tile histograms."""
    return _one_hot(ids_tiled, num_buckets).sum(dim=1).to(torch.int32)


def tile_positions(ids_tiled: Tensor, g: Tensor, num_buckets: int) -> Tensor:
    """(L, T) ids + (L, m) global bases -> (L, T) final destinations:
    ``g[tile, id]`` plus the element's stable rank in its bucket inside its
    tile (paper eq. (2))."""
    one_hot = _one_hot(ids_tiled, num_buckets)
    local = (one_hot * (one_hot.cumsum(dim=1) - 1)).sum(-1)
    base = (one_hot * g[:, None, :].long()).sum(-1)
    return (base + local).to(torch.int32)


def tile_reorder(
    ids_tiled: Tensor, keys_tiled: Tensor, values_tiled: Optional[Tensor], num_buckets: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """Stable bucket-major reorder of each tile (paper §4.7): (keys_r,
    values_r, dest), ``dest[l, t]`` the within-tile destination of element
    t."""
    one_hot = _one_hot(ids_tiled, num_buckets)
    incl = one_hot.cumsum(dim=1)
    local = (one_hot * (incl - 1)).sum(-1)
    hist = incl[:, -1, :]
    starts = hist.cumsum(dim=1) - hist
    dest = (one_hot * starts[:, None, :]).sum(-1) + local
    values_r = None if values_tiled is None else _scatter_rows(dest, values_tiled)
    return _scatter_rows(dest, keys_tiled), values_r, dest.to(torch.int32)


def fused_postscan_reorder(
    ids_tiled: Tensor, g: Tensor, keys_tiled: Tensor, values_tiled: Optional[Tensor],
    num_buckets: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The fused postscan: ``tile_positions`` and ``tile_reorder`` of keys,
    values and the destinations; the element-ordered destinations ride
    along as the fourth output."""
    pos = tile_positions(ids_tiled, g, num_buckets)
    keys_r, values_r, dest = tile_reorder(ids_tiled, keys_tiled, values_tiled, num_buckets)
    return keys_r, values_r, _scatter_rows(dest, pos), pos


def radix_fused_postscan_reorder(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], shift: int, bits: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The fused radix postscan: the digit as the label, then the fused
    postscan."""
    return fused_postscan_reorder(_digits(keys_tiled, shift, bits), g, keys_tiled,
                                  values_tiled, 1 << bits)


def device_histogram(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    """(L, T) ids -> (m,) int32 device-wide histogram (paper §7.3)."""
    return tile_histograms(ids_tiled, num_buckets).sum(dim=0, dtype=torch.int32)


def radix_tile_histograms(keys_tiled: Tensor, shift: int, bits: int) -> Tensor:
    """The digit as the label, then the per-tile histogram (paper §7.1)."""
    return tile_histograms(_digits(keys_tiled, shift, bits), 1 << bits)


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, causal: bool = True) -> Tensor:
    """Naive softmax attention over (BH, S, hd) q, k, v, in float32, the
    result in q's dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bid,bjd->bij", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        n = q.shape[1]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bij,bjd->bid", p, v.float()).to(q.dtype)
