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

The packed bodies (``packed_*``) are the packed family's plain version
(``repro/kernels/common.py:150-410``, in its gather form,
``oblivious=False``): 8-bit subword counters, four to a word, and a
two-level rank, an inclusive scan of packed words inside each subtile and
an exclusive scan of the subtile totals across the subtiles. The JAX
module's ``rank16`` guard and lane-packed rank planes are left out: they
work around what Mosaic lowers, and are not part of the contract. The
packed words are carried as int64 (torch on the CPU has no ``>>`` for
uint32); no lane carries into the next, as a lane counts at most
``subtile <= 2^bits - 1`` keys. A segmented tile takes the combined id
``seg·m + b`` over ``s·m`` buckets, as the JAX kernels do.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

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


def reorder_body(
    ids: Tensor, keys: Tensor, vals: Optional[Tensor], m: int
) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """The standalone tile reorder (the unfused baseline's): (keys_r,
    vals_r, dest), the first two stably bucket-major within each tile and
    ``dest`` each element's destination inside its tile, ``starts[b] +
    rank``. The gather form: slot j of a tile takes the element whose
    destination is j. Keys and values move as bit patterns."""
    rank, _, starts = tile_rank(ids, m)
    dest = starts.gather(1, ids.long()) + rank
    src = torch.argsort(dest, dim=1)                   # dest is a permutation of each tile

    def reorder(x: Tensor) -> Tensor:
        xb = x.view(bits_dtype(x.dtype))
        return xb.gather(1, src).view(x.dtype)

    return reorder(keys), reorder(vals) if vals is not None else None, dest


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


# ---------------------------------------------------------------------------
# Packed subword counters (paper §4.3): the packed family's plain bodies
# ---------------------------------------------------------------------------

DEFAULT_PACKED_BITS = 8      # counter width: k = 32 / bits counters a word


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """The packed-counter geometry of one tile shape: ``bits`` a counter,
    ``k = 32 // bits`` counters a word, ``w = ceil(m_eff / k)`` words a
    key, ``subtile`` keys a level-1 scan (at most ``2^bits - 1``, so no
    lane overflows) and ``n_sub = ceil(tile / subtile)`` subtiles."""

    tile: int
    m_eff: int
    bits: int
    k: int
    w: int
    subtile: int
    n_sub: int

    @property
    def lane_mask(self) -> int:
        return (1 << self.bits) - 1


def packed_layout(
    tile: int, m_eff: int, bits: int = DEFAULT_PACKED_BITS, subtile: Optional[int] = None
) -> PackedLayout:
    """Resolve and guard the packed geometry of one tile, with the JAX
    package's rules and messages: a subtile taller than ``2^bits - 1``
    keys could wrap a counter lane on an all-one-bucket input and raises
    ``ValueError``; the auto subtile is the largest power of two that is
    safe and at most 128."""
    if tile < 1:
        raise ValueError(f"packed layout needs tile >= 1, got {tile}")
    if m_eff < 1:
        raise ValueError(f"packed layout needs m_eff >= 1, got {m_eff}")
    if bits not in (1, 2, 4, 8, 16):
        raise ValueError(
            f"bits-per-counter must divide 32 and be <= 16, got {bits}"
        )
    cap = (1 << bits) - 1                     # max exact count per lane
    if subtile is None:
        subtile = 1
        while subtile * 2 <= min(tile, cap, 128):
            subtile *= 2
    if subtile < 1:
        raise ValueError(f"subtile must be >= 1, got {subtile}")
    if subtile > cap:
        raise ValueError(
            f"subtile={subtile} overflows {bits}-bit packed counters: a "
            f"single-bucket subtile reaches count {subtile} > {cap} "
            f"(= 2^{bits} - 1). Use a shorter subtile or wider counters."
        )
    k = 32 // bits
    return PackedLayout(tile=tile, m_eff=m_eff, bits=bits, k=k, w=-(-m_eff // k),
                        subtile=subtile, n_sub=-(-tile // subtile))


def _packed_chunks(ids: Tensor, layout: PackedLayout) -> Iterator[slice]:
    """Slices of the tile axis whose (l, T, w) packed planes stay within
    the chunk budget."""
    per_tile = layout.n_sub * layout.subtile * layout.w
    step = max(1, _CHUNK_ELEMS // max(1, per_tile))
    for lo in range(0, ids.shape[0], step):
        yield slice(lo, lo + step)


def _packed_pad_ids(ids: Tensor, layout: PackedLayout) -> Tuple[Tensor, int]:
    """Pad each (T,) row to whole subtiles with bucket ``m_eff - 1``: a
    tail pad never changes an earlier key's rank, and the callers take its
    count back out of the last bucket."""
    n_pad = layout.n_sub * layout.subtile - ids.shape[1]
    if n_pad:
        tail = torch.full((ids.shape[0], n_pad), layout.m_eff - 1, dtype=ids.dtype,
                          device=ids.device)
        ids = torch.cat([ids, tail], 1)
    return ids, n_pad


def packed_encode(ids: Tensor, layout: PackedLayout) -> Tensor:
    """(L, T) int32 ids -> (L, T, w) int64 packed one-hot: a key adds
    ``1 << bits·(id mod k)`` to word ``id div k``."""
    idx = ids.long()
    q, shift = idx // layout.k, layout.bits * (idx % layout.k)
    cols = torch.arange(layout.w, device=ids.device)
    unit = torch.ones_like(idx) << shift
    return torch.where(cols == q[..., None], unit[..., None], torch.zeros_like(unit[..., None]))


def packed_unpack(words: Tensor, layout: PackedLayout) -> Tensor:
    """(..., w) int64 packed counters -> (..., m_eff) int32 counts."""
    shifts = layout.bits * torch.arange(layout.k, device=words.device)
    lanes = (words[..., None] >> shifts) & layout.lane_mask
    return lanes.reshape(*words.shape[:-1], layout.w * layout.k)[..., :layout.m_eff].to(torch.int32)


def _packed_state(ids: Tensor, layout: PackedLayout) -> Tuple[Tensor, Tensor, Tensor]:
    """The two-level solve of (L, T) ids: (rank_incl, sub_hist, excl_sub),
    the 1-based rank of each key in its (subtile, bucket) cell (L, T_pad),
    the (L, S, m_eff) subtile histograms and their exclusive scan over the
    subtiles, the level-2 carry."""
    ids_p, _ = _packed_pad_ids(ids, layout)
    n_tiles, t_pad = ids_p.shape
    idx = ids_p.long()
    q, shift = idx // layout.k, layout.bits * (idx % layout.k)
    contrib = packed_encode(ids_p, layout)
    # level 1: inclusive scan of packed words inside each subtile; counts
    # stay <= subtile <= 2^bits - 1, so no lane carries into the next
    incl4 = torch.cumsum(contrib.view(n_tiles, layout.n_sub, layout.subtile, layout.w), 2)
    word = incl4.view(n_tiles, t_pad, layout.w).gather(2, q[..., None])[..., 0]
    rank_incl = ((word >> shift) & layout.lane_mask).to(torch.int32)
    # level 2: unpack only the S subtile totals and scan those
    sub_hist = packed_unpack(incl4[:, :, -1, :], layout)
    excl_sub = torch.cumsum(sub_hist, 1, dtype=torch.int32) - sub_hist
    return rank_incl, sub_hist, excl_sub


def _drop_pad_count(hist: Tensor, m_eff: int, n_pad: int) -> Tensor:
    if n_pad:
        hist[:, m_eff - 1] -= n_pad
    return hist


def packed_local_offsets(ids: Tensor, layout: PackedLayout) -> Tuple[Tensor, Tensor]:
    """(L, T) ids -> (local, hist): the stable 0-based rank of each key in
    its bucket of its tile (L, T) and the tile histograms (L, m_eff), both
    int32, bitwise those of the one-hot :func:`tile_rank`."""
    n_tiles, t = ids.shape
    local = torch.empty((n_tiles, t), dtype=torch.int32, device=ids.device)
    hist = torch.empty((n_tiles, layout.m_eff), dtype=torch.int32, device=ids.device)
    sub_idx = torch.arange(t, device=ids.device) // layout.subtile
    n_pad = layout.n_sub * layout.subtile - t
    for sl in _packed_chunks(ids, layout):
        chunk = ids[sl]
        rank_incl, sub_hist, excl_sub = _packed_state(chunk, layout)
        at = sub_idx * layout.m_eff + chunk.long()
        carry = excl_sub.reshape(chunk.shape[0], -1).gather(1, at)
        local[sl] = carry + rank_incl[:, :t] - 1
        hist[sl] = _drop_pad_count(sub_hist.sum(1, dtype=torch.int32), layout.m_eff, n_pad)
    return local, hist


def packed_counts(ids: Tensor, layout: PackedLayout) -> Tensor:
    """(L, T) ids -> (L, m_eff) int32 tile histograms: the packed sums of
    each subtile (no scan) and one unpack."""
    hist = torch.empty((ids.shape[0], layout.m_eff), dtype=torch.int32, device=ids.device)
    for sl in _packed_chunks(ids, layout):
        ids_p, n_pad = _packed_pad_ids(ids[sl], layout)
        contrib = packed_encode(ids_p, layout)
        sub_tot = contrib.view(ids_p.shape[0], layout.n_sub, layout.subtile, layout.w).sum(2)
        hist[sl] = _drop_pad_count(packed_unpack(sub_tot, layout).sum(1, dtype=torch.int32),
                                   layout.m_eff, n_pad)
    return hist


def packed_positions_body(ids: Tensor, g: Tensor, layout: PackedLayout) -> Tensor:
    """Packed DMS postscan: (L, T) global destinations ``G[id] + rank``
    (paper eq. (2)), int32 throughout."""
    local, _ = packed_local_offsets(ids, layout)
    return g.gather(1, ids.long()) + local


def packed_postscan_body(
    ids: Tensor, g: Tensor, keys: Tensor, vals: Optional[Tensor], layout: PackedLayout
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The packed fused postscan: the contract of :func:`postscan_body`
    (keys_r, vals_r, pos_r, perm) on the two-level packed rank."""
    local, hist = packed_local_offsets(ids, layout)
    idx = ids.long()
    starts = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    dest = (starts.gather(1, idx) + local).long()                  # within the tile
    gpos = g.gather(1, idx) + local

    def reorder(x: Tensor) -> Tensor:
        xb = x.view(bits_dtype(x.dtype))
        return torch.empty_like(xb).scatter_(1, dest, xb).view(x.dtype)

    vals_r = reorder(vals) if vals is not None else None
    return reorder(keys), vals_r, reorder(gpos), gpos


# ---------------------------------------------------------------------------
# Fused two-digit radix (paper §7.1, two digit passes a tile): the fused2
# family's plain bodies
# ---------------------------------------------------------------------------

# The in-tile sub-digit stage width of the plain bodies: the JAX package's
# default (measured on a CPU host). Every width gives the same bits.
FUSED2_SUB_BITS = 4


def _digit(u: Tensor, shift: int, bits: int) -> Tensor:
    """``(u >> shift) & (2^bits - 1)`` of int64 key words, as int32."""
    return ((u >> shift) & ((1 << bits) - 1)).to(torch.int32)


def _key_words(keys: Tensor) -> Tensor:
    """The keys' 32-bit words as non-negative int64 (torch on the CPU has
    no ``>>`` for uint32)."""
    return keys.to(torch.int64) & 0xFFFFFFFF


def fused2_split_digits(keys: Tensor, shift: int, bits_lo: int,
                        bits_hi: int) -> Tuple[Tensor, Tensor]:
    """(lo, hi) int32 digit strips of the pair bitfield at ``shift``: the
    arithmetic of ``BitfieldSpec.emit`` on each half, so the pair agrees
    bitwise with the two chained single-digit passes."""
    u = _key_words(keys)
    return _digit(u, shift, bits_lo), _digit(u, shift + bits_lo, bits_hi)


def fused2_stage_local(ids: Tensor, m: int, family: str) -> Tuple[Tensor, Tensor]:
    """One m-wide stage solve of the pair's sweep in the plan's kernel
    family: (stable in-bucket rank (L, T), histogram (L, m)), from the
    one-hot rank or the packed two-level rank (bitwise the same)."""
    if family == "packed":
        return packed_local_offsets(ids, packed_layout(ids.shape[1], m))
    rank, hist, _ = tile_rank(ids, m)
    return rank, hist


def fused2_counts_body(keys: Tensor, shift: int, bits: int, seg: Optional[Tensor] = None,
                       num_segments: int = 1) -> Tensor:
    """(L, T) integer keys [+ segment ids] -> (L, s·m²) int32 histograms of
    the cell ``cg = seg·m² + pair``, ``pair = (u >> shift) & (m² - 1)``,
    by scatter-add (order-invariant: computed on the tile as it is)."""
    m2 = 1 << bits
    pair = _digit(_key_words(keys), shift, bits)
    cg = pair if seg is None else seg * m2 + pair
    return counts_body(cg, m2 * num_segments)


def fused2_postscan_body(
    keys: Tensor, g: Tensor, vals: Optional[Tensor], shift: int, split: int, bits: int,
    seg: Optional[Tensor] = None, num_segments: int = 1, family: str = "onehot",
    sub_bits: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The fused two-digit postscan of every tile: the contract of
    :func:`postscan_body` (keys_r, vals_r, pos_r, perm) over the ``bits``
    wide pair, the first three stably (seg, pair)-major within the tile.

    ``split`` names the two chained passes the pair replaces; by the LSD
    identity the result depends only on the combined stable pass, so the
    body is free to decompose it: an LSD sweep of ``sub_bits``-wide stages
    (a stable stage solve of the plan's family and a reorder each), then the
    segment as the most significant stage. The segment stage is a stable
    sort of the segment ids: s can be far wider than a one-hot plane should
    be. After the sweep each cell is a contiguous run of the tile, so a
    key's stable rank in its cell is its position minus the run's head (a
    running maximum of the heads). Values never move per stage: the tracked
    source index gathers them once.

    The JAX body's oblivious matmul forms, ``_pair_hist2d_shape`` and
    ``fused2_vmem_bytes`` are Mosaic and VMEM workarounds and no part of
    the contract; this is its gather form (``oblivious=False``), int32
    throughout."""
    del split
    if seg is None and num_segments != 1:
        raise ValueError(f"num_segments={num_segments} needs a segment strip")
    sb = sub_bits or FUSED2_SUB_BITS
    n_tiles, t = keys.shape
    dev = keys.device
    u = _key_words(keys)
    idx = torch.arange(t, device=dev).expand(n_tiles, t)
    for off in range(0, bits, sb):
        b = min(sb, bits - off)
        d = _digit(u, shift + off, b)
        local, hist = fused2_stage_local(d, 1 << b, family)
        starts = torch.cumsum(hist, 1, dtype=torch.int32) - hist
        dest = (starts.gather(1, d.long()) + local).long()
        u = torch.empty_like(u).scatter_(1, dest, u)
        idx = torch.empty_like(idx).scatter_(1, dest, idx)
    if seg is not None and num_segments > 1:
        order = torch.sort(seg.gather(1, idx), dim=1, stable=True).indices
        u, idx = u.gather(1, order), idx.gather(1, order)
    pair = _digit(u, shift, bits)
    cg = pair if seg is None else seg.gather(1, idx) * (1 << bits) + pair
    pos = torch.arange(t, device=dev).expand(n_tiles, t)
    head = torch.ones((n_tiles, t), dtype=torch.bool, device=dev)
    head[:, 1:] = cg[:, 1:] != cg[:, :-1]
    cell_start = torch.cummax(torch.where(head, pos, torch.zeros_like(pos)), 1).values
    pos_r = g.gather(1, cg.long()) + (pos - cell_start).to(torch.int32)
    perm = torch.empty_like(pos_r).scatter_(1, idx, pos_r)

    def gather(x: Tensor) -> Tensor:
        return x.view(bits_dtype(x.dtype)).gather(1, idx).view(x.dtype)

    return gather(keys), gather(vals) if vals is not None else None, pos_r, perm


def fused2_positions_body(
    keys: Tensor, g: Tensor, shift: int, split: int, bits: int, seg: Optional[Tensor] = None,
    num_segments: int = 1, family: str = "onehot", sub_bits: Optional[int] = None,
) -> Tensor:
    """The fused two-digit DMS postscan: (L, T) global pair destinations in
    element order, the ``perm`` of :func:`fused2_postscan_body`."""
    return fused2_postscan_body(keys, g, None, shift, split, bits, seg=seg,
                                num_segments=num_segments, family=family, sub_bits=sub_bits)[3]
