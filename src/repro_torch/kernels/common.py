"""The plain in-tile body of the multisplit kernels.

Counterpart of the ``one_hot_f32`` / ``cumsum_mxu`` / ``fused_postscan_body``
trio of ``repro/kernels/common.py:55-148``. One int32 evaluation per tile
gives the stable in-bucket rank, the tile histogram and the tile bucket
starts (paper Alg. 3, without ballots); the postscan bodies derive the
within-tile destination, the global destination ``G[b] + rank`` (eq. (2))
and the bucket-major reorder from it.

Everything is exact int32. The Pallas bodies add ``G + rank`` in float32,
which is exact only below 2^24 (ROADMAP §C); these bodies, and the CUDA
kernels they are the plain version of, never leave int32.

These bodies are the CPU path of the kernel wrappers, the tiled stages of
the ``vmap`` backend, and the oracle the kernels are held against on the
card. They are no yardstick of speed.

The segmented bodies (``seg_*``) work over the combined id ``cid = seg·m +
b`` of ``repro/kernels/multisplit_tile.py:504-632``: the rank comes from
the m-wide one-hot with a per-segment carry, as the JAX ``VmapStages`` do
(``repro/core/pipeline/registry.py:257-268, 303-316``), and the histogram
is a scatter-add into ``s·m`` columns.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.identifiers import bits_dtype

Tensor = torch.Tensor

# Elements of the (tiles, T, m) one-hot plane evaluated at once: bounds the
# working set of the plain body (about 9 bytes an element) at any size.
_CHUNK_ELEMS = 1 << 25


def tile_rank(ids: Tensor, m: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(L, T) int32 bucket ids -> (rank, hist, starts): the stable rank of
    each element among the earlier elements of its bucket in its tile
    (L, T), the tile histograms (L, m) and the tile bucket starts (L, m),
    all int32, from one one-hot cumsum per tile."""
    n_tiles, t = ids.shape
    rank = torch.empty((n_tiles, t), dtype=torch.int32, device=ids.device)
    hist = torch.empty((n_tiles, m), dtype=torch.int32, device=ids.device)
    cols = torch.arange(m, dtype=torch.int32, device=ids.device)
    step = max(1, _CHUNK_ELEMS // max(1, t * m))
    for lo in range(0, n_tiles, step):
        chunk = ids[lo:lo + step]
        one_hot = (chunk[:, :, None] == cols).to(torch.int32)     # (l, T, m)
        incl = torch.cumsum(one_hot, 1, dtype=torch.int32)
        rank[lo:lo + step] = incl.gather(2, chunk[:, :, None].long())[:, :, 0] - 1
        hist[lo:lo + step] = incl[:, -1, :] if t else 0
    starts = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    return rank, hist, starts


def counts_body(ids: Tensor, m: int) -> Tensor:
    """(L, T) ids -> (L, m) int32 tile histograms by scatter-add."""
    hist = torch.zeros((ids.shape[0], m), dtype=torch.int32, device=ids.device)
    return hist.scatter_add_(1, ids.long(), torch.ones_like(ids))


def positions_body(ids: Tensor, g: Tensor, m: int) -> Tensor:
    """(L, T) ids + (L, m) bases -> (L, T) global destinations
    ``G[l, b] + rank`` (paper eq. (2)), in element order."""
    rank, _, _ = tile_rank(ids, m)
    return g.gather(1, ids.long()) + rank


def postscan_body(
    ids: Tensor, g: Tensor, keys: Tensor, vals: Optional[Tensor], m: int
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The fused WMS/BMS postscan of every tile: (keys_r, vals_r, pos_r,
    perm). ``keys_r``, ``vals_r`` and ``pos_r`` are stably bucket-major
    within each tile, ``pos_r`` holding each reordered slot's global
    destination; ``perm`` is the element-order destination ``G[b] + rank``.
    Keys and values move as bit patterns."""
    rank, _, starts = tile_rank(ids, m)
    idx = ids.long()
    dest = (starts.gather(1, idx) + rank).long()                  # within the tile
    gpos = g.gather(1, idx) + rank

    def reorder(x: Tensor) -> Tensor:
        xb = x.view(bits_dtype(x.dtype))
        return torch.empty_like(xb).scatter_(1, dest, xb).view(x.dtype)

    vals_r = reorder(vals) if vals is not None else None
    return reorder(keys), vals_r, reorder(gpos), gpos


# ---------------------------------------------------------------------------
# Segmented bodies: the combined id cid = seg·m + b, with the segment ids of
# each tile non-decreasing (the input is segment-contiguous).
# ---------------------------------------------------------------------------

def seg_tile_rank(ids: Tensor, seg: Tensor, m: int) -> Tensor:
    """(L, T) int32 bucket ids and segment ids -> (L, T) int32 stable rank
    of each element among the earlier elements of its (segment, bucket) in
    its tile. The m-wide one-hot cumsum of :func:`tile_rank` minus a
    per-segment carry: the count of the bucket before the first element of
    the segment in the tile. O(T·m) whatever the number of segments; an
    s·m-wide one-hot is never formed."""
    n_tiles, t = ids.shape
    rank = torch.empty((n_tiles, t), dtype=torch.int32, device=ids.device)
    cols = torch.arange(m, dtype=torch.int32, device=ids.device)
    step = max(1, _CHUNK_ELEMS // max(1, t * m))
    for lo in range(0, n_tiles, step):
        chunk, sg = ids[lo:lo + step], seg[lo:lo + step].contiguous()
        one_hot = (chunk[:, :, None] == cols).to(torch.int32)     # (l, T, m)
        incl = torch.cumsum(one_hot, 1, dtype=torch.int32).view(chunk.shape[0], t * m)
        idx = chunk.long()
        first = torch.searchsorted(sg, sg, right=False)             # first row of my segment
        at_first = first * m + idx
        carry = incl.gather(1, at_first) - (chunk.gather(1, first) == chunk).to(torch.int32)
        rank[lo:lo + step] = incl.gather(1, torch.arange(t, device=ids.device) * m + idx) - carry - 1
    return rank


def combined_ids(ids: Tensor, seg: Tensor, m: int) -> Tensor:
    """``seg·m + b`` in int32 (s·m < 2^31)."""
    return seg * m + ids


def seg_counts_body(ids: Tensor, seg: Tensor, m: int, s: int) -> Tensor:
    """(L, T) ids and segment ids -> (L, s·m) int32 histograms of the
    combined id, by scatter-add."""
    return counts_body(combined_ids(ids, seg, m), s * m)


def seg_positions_body(ids: Tensor, seg: Tensor, g: Tensor, m: int) -> Tensor:
    """(L, T) ids and segment ids + (L, s·m) bases -> (L, T) global
    destinations ``G[l, cid] + rank``, in element order."""
    rank = seg_tile_rank(ids, seg, m)
    return g.gather(1, combined_ids(ids, seg, m).long()) + rank


def seg_postscan_body(
    ids: Tensor, seg: Tensor, g: Tensor, keys: Tensor, vals: Optional[Tensor], m: int, s: int
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The segmented fused postscan of every tile, the contract of
    :func:`postscan_body` over the combined id: ``keys_r``, ``vals_r`` and
    ``pos_r`` stably (segment, bucket)-major within each tile."""
    rank = seg_tile_rank(ids, seg, m)
    cid32 = combined_ids(ids, seg, m)
    hist = counts_body(cid32, s * m)
    cid = cid32.long()
    starts = torch.cumsum(hist, 1, dtype=torch.int32) - hist        # (L, s·m) tile starts
    dest = (starts.gather(1, cid) + rank).long()
    gpos = g.gather(1, cid) + rank

    def reorder(x: Tensor) -> Tensor:
        xb = x.view(bits_dtype(x.dtype))
        return torch.empty_like(xb).scatter_(1, dest, xb).view(x.dtype)

    vals_r = reorder(vals) if vals is not None else None
    return reorder(keys), vals_r, reorder(gpos), gpos
