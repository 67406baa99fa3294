"""Stage primitives of the multisplit pipeline (paper §4.1).

Counterpart of ``repro/core/pipeline/stages.py`` for the flat, batched
and segmented layouts: every
multisplit variant factors into {local prescan} -> {one global scan} ->
{local postscan (+ reorder)}. This module owns the layout and scan
primitives and the O(n·m) direct solve, with no backend logic. The in-tile
body (stable rank, tile histogram, tile starts) lives in
:mod:`repro_torch.kernels.common`, beside the kernels it is the plain
version of.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.identifiers import bits_dtype
from repro_torch.kernels.common import (
    fused2_counts_body,
    fused2_postscan_body,
    packed_layout,
    packed_local_offsets,
    seg_tile_rank,
    tile_rank,
)

Tensor = torch.Tensor


class MultisplitResult(NamedTuple):
    """Flat plans: shapes as commented. Segmented plans keep flat ``(n,)``
    data (each segment occupies its input span) and return ``(s, m)``
    segment-local starts and counts and a segment-local ``(n,)``
    permutation. Partial pipelines return ``None`` for the fields they
    never compute: ``counts_only`` fills only
    ``bucket_starts``/``bucket_counts``; ``positions_only`` also fills
    ``permutation``."""

    keys: Optional[Tensor]          # permuted keys, bucket-major, stable
    values: Optional[Tensor]        # permuted values (None for key-only)
    bucket_starts: Tensor           # (m,) start index of each bucket
    bucket_counts: Tensor           # (m,) histogram
    permutation: Optional[Tensor]   # (n,) dest position of input element i


def segment_ids_from_starts(segment_starts: Tensor, n: int) -> Tensor:
    """(s,) ascending start offsets (``starts[0] == 0``) -> (n,) int32
    segment id of each element. Equal consecutive starts are empty segments;
    the last segment ends at ``n``.

    The id of element i is the number of starts at or before i, minus one
    (``searchsorted(starts, i, right=True) - 1``), computed as a prefix sum
    of start marks: one pass over n instead of a binary search per
    element."""
    starts = segment_starts.to(torch.int32).clamp(0, n)
    marks = torch.zeros((n + 1,), dtype=torch.int32, device=starts.device)
    marks.index_add_(0, starts, torch.ones_like(starts))
    return torch.cumsum(marks[:n], 0, dtype=torch.int32) - 1


def as_bits(x: Tensor) -> Tensor:
    """Bit-pattern view of ``x`` as the signed integer type of its width."""
    return x.view(bits_dtype(x.dtype))


def bits_fill(fill, dtype: torch.dtype) -> int:
    """``fill`` (a value of ``dtype``) as the bit pattern of :func:`as_bits`."""
    return int(as_bits(torch.tensor([fill], dtype=dtype)).item())


def pad_to_tiles(x: Tensor, tile: int, fill) -> Tuple[Tensor, int]:
    """Pad a 1-D tensor to a multiple of ``tile`` with ``fill`` (a value of
    ``x``'s dtype); padding runs on the bit-pattern view, so it works for
    every 32-bit key type on every device."""
    n = x.shape[0]
    n_pad = (-n) % tile
    if n_pad:
        xb = as_bits(x)
        tail = torch.full((n_pad,), bits_fill(fill, x.dtype), dtype=xb.dtype, device=x.device)
        x = torch.cat([xb, tail]).view(x.dtype)
    return x, n_pad


def pad_rows(x: Tensor, n_row: int, fill) -> Tensor:
    """Pad every row of a ``(b, n)`` tensor out to ``n_row`` columns with
    ``fill`` (a value of ``x``'s dtype), on the bit-pattern view as
    :func:`pad_to_tiles` does."""
    b, n = x.shape
    if n_row == n:
        return x.contiguous()
    xb = as_bits(x)
    tail = torch.full((b, n_row - n), bits_fill(fill, x.dtype), dtype=xb.dtype, device=x.device)
    return torch.cat([xb, tail], 1).view(x.dtype)


def global_scan(hist_per_tile: Tensor, rows: int = 1) -> Tensor:
    """Exclusive scan over the bucket-major H (paper §4.1): (L, m) int32
    tile histograms -> (L, m) int32 bases G, where G[l, b] is the global
    start of (tile l, bucket b). With ``rows=b`` the L tiles are b rows of
    L/b tiles each (the batched layout) and every row is scanned on its own,
    its bases starting at 0: the counterpart of ``jax.vmap(global_scan)``
    over ``(b, L/b, m)``, in one cumsum."""
    n_tiles, m = hist_per_tile.shape
    l_b = n_tiles // rows
    h_t = hist_per_tile.view(rows, l_b, m).transpose(1, 2).reshape(-1)  # bucket-major rows
    g = (torch.cumsum(h_t, 0, dtype=torch.int32) - h_t).view(rows, m * l_b)
    if rows > 1:
        # one scan over all rows, as the flat layout's, then each row less
        # the total of the rows before it (PERF.md: a cumsum along the rows
        # is slower on the card)
        g = g - g[:, :1]
    return g.view(rows, m, l_b).transpose(1, 2).contiguous().view(n_tiles, m)


def exclusive_rows(counts: Tensor) -> Tensor:
    """Exclusive prefix along the last axis: bucket start offsets."""
    return (torch.cumsum(counts, -1, dtype=torch.int32) - counts).to(torch.int32)


def tile_local_offsets(ids: Tensor, m: int) -> Tuple[Tensor, Tensor]:
    """(stable in-bucket rank, histogram) of one (T,) strip of ids."""
    rank, hist, _ = tile_rank(ids.reshape(1, -1), m)
    return rank[0], hist[0]


def seg_tile_local(ids: Tensor, segs: Tensor, m: int) -> Tensor:
    """Segmented stable in-bucket rank of one (T,) strip whose segment ids
    never decrease: the m-wide cumsum with a per-segment carry, O(T·m)
    whatever the number of segments."""
    return seg_tile_rank(ids.reshape(1, -1), segs.reshape(1, -1), m)[0]


def row_index(pos: Tensor, rows: int) -> Tensor:
    """The flat int64 scatter index of row-local destinations: ``pos`` holds
    ``rows`` rows of destinations into their own row, and row r's land at
    ``r·n_row + pos``, so one flat scatter serves the whole batch."""
    n_row = pos.numel() // rows
    offsets = torch.arange(0, rows * n_row, n_row, dtype=torch.int64, device=pos.device)
    # int32 + int64 promotes inside the add: one pass, as the flat .long()
    return (pos.reshape(rows, n_row) + offsets[:, None]).reshape(-1)


def scatter(src: Tensor, idx: Tensor, n_total: int) -> Tensor:
    """``out[idx[i]] = src[i]`` for an int64 permutation ``idx`` of
    ``range(n_total)``, on the int32 bit-pattern view (``index_copy_``)."""
    sb = as_bits(src.reshape(-1))
    out = torch.empty((n_total,), dtype=sb.dtype, device=src.device)
    out.index_copy_(0, idx, sb)
    return out.view(src.dtype)


def packed_tile_local_offsets(ids: Tensor, m: int) -> Tuple[Tensor, Tensor]:
    """The packed analogue of :func:`tile_local_offsets`: (stable in-bucket
    rank, histogram) of one (T,) strip from 8-bit subword counters and the
    two-level subtile scan, bitwise equal to it (the gather form)."""
    local, hist = packed_local_offsets(ids.reshape(1, -1), packed_layout(ids.shape[0], m))
    return local[0], hist[0]


def fused2_tile_counts(keys: Tensor, shift: int, bits: int, seg: Optional[Tensor] = None,
                       num_segments: int = 1) -> Tensor:
    """The (s·m²,) pair histogram of one (T,) strip of keys [and segment
    ids]: the fused two-digit prescan of one tile."""
    seg = None if seg is None else seg.reshape(1, -1)
    return fused2_counts_body(keys.reshape(1, -1), shift, bits, seg, num_segments)[0]


def fused2_tile_postscan(
    keys: Tensor, g_row: Tensor, vals: Optional[Tensor], shift: int, split: int, bits: int,
    seg: Optional[Tensor] = None, num_segments: int = 1, family: str = "onehot",
    sub_bits: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The fused two-digit postscan of one (T,) strip: (keys_r, vals_r,
    pos_r, perm) over the pair, the first three stably (seg, pair)-major."""
    row = lambda x: None if x is None else x.reshape(1, -1)
    out = fused2_postscan_body(row(keys), row(g_row), row(vals), shift, split, bits, row(seg),
                               num_segments, family, sub_bits)
    return tuple(None if x is None else x[0] for x in out)


def _direct_solve_with(
    local_offsets, keys: Tensor, ids: Tensor, m: int, values: Optional[Tensor]
) -> MultisplitResult:
    """Paper eq. (1) on precomputed bucket ids with the local solve of a
    kernel family: the whole input is one subproblem."""
    n = keys.shape[0]
    if n == 0:
        zeros = torch.zeros((m,), dtype=torch.int32, device=keys.device)
        perm = torch.zeros((0,), dtype=torch.int32, device=keys.device)
        return MultisplitResult(keys, values, zeros, zeros, perm)
    local, hist = local_offsets(ids, m)
    starts = exclusive_rows(hist)
    perm = starts[ids.long()] + local
    idx = perm.long()
    keys_out = scatter(keys, idx, n)
    values_out = scatter(values, idx, n) if values is not None else None
    return MultisplitResult(keys_out, values_out, starts, hist, perm)


def direct_solve_ids(
    keys: Tensor, ids: Tensor, m: int, values: Optional[Tensor]
) -> MultisplitResult:
    """O(n·m) direct evaluation of paper eq. (1) on precomputed bucket ids:
    the whole input is one subproblem."""
    return _direct_solve_with(tile_local_offsets, keys, ids, m, values)


def direct_solve_reference(
    keys: Tensor, bucket_fn, values: Optional[Tensor]
) -> MultisplitResult:
    """O(n·m) direct evaluation of paper eq. (1) on the spec's own labels:
    the oracle (``repro/core/pipeline/stages.py:232``)."""
    return direct_solve_ids(keys, bucket_fn(keys).to(torch.int32), bucket_fn.num_buckets, values)


def packed_direct_solve_ids(
    keys: Tensor, ids: Tensor, m: int, values: Optional[Tensor]
) -> MultisplitResult:
    """The packed family's direct solve (the reference backend's packed
    oracle), bitwise equal to :func:`direct_solve_ids`."""
    return _direct_solve_with(packed_tile_local_offsets, keys, ids, m, values)


def direct_counts(ids: Tensor, m: int) -> Tensor:
    """Histogram of bucket ids via scatter-add: the counts_only form of the
    direct solve."""
    out = torch.zeros((m,), dtype=torch.int32, device=ids.device)
    return out.index_add_(0, ids.reshape(-1).long(), torch.ones_like(ids.reshape(-1)))
