"""The multisplit tile kernels for Hopper, each beside its plain version.

Counterpart of the fused-label kernels of ``repro/kernels/multisplit_tile.py``:

* :func:`spec_tile_histograms` (K1, ``csrc/tile_histograms.cu``) replaces
  ``spec_tile_histograms_pallas`` (``multisplit_tile.py:368``): keys (L, T)
  -> (L, m) int32 tile histograms.
* :func:`spec_fused_postscan_reorder` (K2,
  ``csrc/fused_postscan_reorder.cu``) replaces
  ``spec_fused_postscan_reorder_pallas`` (``:460``): keys (L, T), bases G
  (L, m) and optional values -> (keys_r, vals_r, pos_r, perm).
* :func:`spec_tile_positions` (K3, ``csrc/tile_positions.cu``) replaces
  ``spec_tile_positions_pallas`` (``:396``): keys and G -> (L, T) int32
  destinations ``G[b] + rank``.
* :func:`seg_spec_tile_histograms` (K1s, ``csrc/seg_tile_histograms.cu``),
  :func:`seg_spec_fused_postscan_reorder` (K2s,
  ``csrc/seg_fused_postscan_reorder.cu``) and :func:`seg_spec_tile_positions`
  (K3s, ``csrc/seg_tile_positions.cu``) replace
  ``seg_spec_tile_histograms_pallas`` (``:512``),
  ``seg_spec_fused_postscan_reorder_pallas`` (``:587``) and
  ``seg_spec_tile_positions_pallas`` (``:544``): the same contracts over the
  combined id ``cid = seg·m + b``, with an (L, T) int32 segment strip that
  never decreases along a tile and (L, s·m) histograms and bases.

Labels are computed inside those kernels from the declarative spec, which
each wrapper flattens to scalars (:func:`label_args`). Keys and values are
32-bit words: int32, uint32 or float32.

Counterpart of the materialised-label (ids-strip) kernels, for labels a
programmer's bucket function computed outside the kernels:

* :func:`tile_histograms`, :func:`tile_positions`,
  :func:`seg_tile_histograms` and :func:`seg_tile_positions` replace
  ``tile_histograms_pallas`` (``:94``), ``tile_positions_pallas``
  (``:123``), ``seg_tile_histograms_pallas`` (``:227``) and
  ``seg_tile_positions_pallas`` (``:259``): K1, K3, K1s and K3s launched on
  the (L, T) int32 ids strip as their keys under the identity label.
* :func:`fused_postscan_reorder` and :func:`seg_fused_postscan_reorder`
  replace ``fused_postscan_reorder_pallas`` (``:168``) and
  ``seg_fused_postscan_reorder_pallas`` (``:303``): the ids entry points of
  K2 and K2s, which read labels from the ids strip and move the keys.
* :func:`spec_bucket_ids` (``csrc/spec_bucket_ids.cu``) replaces
  ``spec_bucket_ids_pallas`` (``:421``): keys (L, T) -> the spec's int32
  labels (L, T), bitwise the labels K1-K3 compute in-register.
* :func:`tile_reorder` (B10, ``csrc/tile_reorder.cu``) replaces
  ``tile_reorder_pallas`` (``:1061``): the unfused baseline's standalone
  reorder, ids, keys [and values] (L, T) -> keys and values stably
  bucket-major within each tile and each element's in-tile destination.

Counterpart of the packed-counter family (paper §4.3), one wrapper a
pipeline stage for {labels in-kernel from a spec | an ids strip} × {flat |
segmented}, with the JAX doors' arguments (``repro/kernels/ops.py:193-270``):

* :func:`packed_tile_histograms` (K1p, ``csrc/packed_tile_histograms.cu``)
  replaces ``packed_tile_histograms_pallas`` (``:662``);
* :func:`packed_tile_positions` (K3p, ``csrc/packed_tile_positions.cu``)
  replaces ``packed_tile_positions_pallas`` (``:706``);
* :func:`packed_fused_postscan_reorder` (K2p,
  ``csrc/packed_fused_postscan_reorder.cu``) replaces
  ``packed_fused_postscan_reorder_pallas`` (``:772``).

Their outputs are the onehot kernels' bit for bit; the family is a cost
axis. The kernels take 8-bit counters and any subtile the guard of
:func:`~repro_torch.kernels.common.packed_layout` accepts (1 to 255 keys);
other ``bits`` raise ``ValueError`` on a CUDA tensor.

Counterpart of the fused two-digit radix kernels (two digit passes a tile,
the pair a ``BitfieldSpec`` of up to 16 bits; ``repro/kernels/ops.py:272-340``),
one wrapper a stage for {flat | segmented} × {onehot | packed stage rank}:

* :func:`fused2_tile_histograms` (K1f, ``csrc/fused2_tile_histograms.cu``)
  replaces ``fused2_tile_histograms_pallas`` (``:863``);
* :func:`fused2_tile_positions` (K3f, ``csrc/fused2_tile_positions.cu``)
  replaces ``fused2_tile_positions_pallas`` (``:909``);
* :func:`fused2_fused_postscan_reorder` (K2f,
  ``csrc/fused2_fused_postscan_reorder.cu``) replaces
  ``fused2_fused_postscan_reorder_pallas`` (``:973``).

They take integer keys (int32 or uint32). Their result depends on neither
``split``, ``family`` nor ``sub_bits`` (the LSD identity); the kernels take
pairs of 1 to 16 bits and stages of 1 to 8 bits, and other widths raise
``ValueError`` on a CUDA tensor.

The label of an id is ``min(max(id, 0), m - 1)`` in every kernel and plain
version: an id outside ``[0, m)`` is outside the contract, as an
``IdentitySpec`` key is, and the clamp only keeps it from writing out of
bounds.

Dispatch: a wrapper runs its plain version (``*_plain``, pure torch, the
same function) only for a tensor on the CPU. For a CUDA tensor it launches
the kernel on the current stream, checks the C function's return code
(``cudaGetLastError()`` after the launch) and raises on any error; a failed
build raises too. Nothing falls back. Each wrapper counts its launches in
its ``launches`` attribute, incremented only where the kernel launches;
:mod:`repro_torch.kernels` registers the wrappers and resets the counts.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.identifiers import (
    BitfieldSpec,
    DeltaSpec,
    EvenSpec,
    IdentitySpec,
    RangeSpec,
)
from repro_torch.kernels import build, common
from repro_torch.kernels.build import on_cuda, raise_on, stream

Tensor = torch.Tensor

MAX_BUCKETS = 256         # one thread per bucket in the kernels' scans
MAX_TILE = 8192           # the kernels' rank holds at most 32 keys a lane (8 warps)

KEY_KINDS = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}
_SPEC_KINDS = {DeltaSpec: 0, IdentitySpec: 1, BitfieldSpec: 2, RangeSpec: 3, EvenSpec: 4}
_NP_PLANE = {torch.int32: np.int32, torch.uint32: np.uint32, torch.float32: np.float32}


# ---------------------------------------------------------------------------
# Spec -> kernel label arguments
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _splitter_words(spec: RangeSpec, key_dtype: torch.dtype, device: torch.device):
    """(plane kind, splitters as 32-bit compare-plane words on ``device``)."""
    plane, vals = spec.compare_plane(key_dtype)
    words = np.asarray(vals, _NP_PLANE[plane]).view(np.int32)
    return KEY_KINDS[plane], torch.from_numpy(words.copy()).to(device)


def label_args(spec, key_dtype: torch.dtype, device: torch.device) -> Tuple:
    """The kernels' ten label arguments for ``spec`` over keys of
    ``key_dtype``: (kind, key_kind, m, u0, u1, f0, f1, splitters, n_split,
    plane). Raises for a spec or key type the kernels do not take."""
    kind = _SPEC_KINDS.get(type(spec))
    if kind is None:
        raise NotImplementedError(
            f"the CUDA kernels compute labels in-kernel for the declarative specs only, "
            f"not {type(spec).__name__}: materialise its labels and pass the int32 ids "
            f"strip to the ids kernels (tile_histograms, tile_positions, "
            f"fused_postscan_reorder and their seg_ forms)"
        )
    if key_dtype not in KEY_KINDS:
        raise ValueError(f"the CUDA kernels take 32-bit keys (int32, uint32, float32), got {key_dtype}")
    m = spec.num_buckets
    _check_m(m)
    u0 = u1 = 0
    f0 = f1 = 0.0
    splitters, n_split, plane = None, 0, 0
    if isinstance(spec, DeltaSpec):
        u0 = spec.delta
        if u0 >= 1 << 32:
            raise ValueError(f"DeltaSpec delta {u0} does not fit the kernels' uint32 keys")
    elif isinstance(spec, BitfieldSpec):
        spec._check_integer(key_dtype)
        u0, u1 = spec.shift, spec.mask
    elif isinstance(spec, RangeSpec):
        n_split = len(spec.splitters)
        if n_split:
            plane, words = _splitter_words(spec, key_dtype, device)
            splitters = words.data_ptr()
    elif isinstance(spec, EvenSpec):
        f0, f1 = float(np.float32(spec.lo)), float(np.float32(spec.width))
    return (kind, KEY_KINDS[key_dtype], m, u0, u1, f0, f1, splitters, n_split, plane)


def _check_m(m: int) -> None:
    if not 1 <= m <= MAX_BUCKETS:
        raise ValueError(f"the CUDA kernels take 1 <= m <= {MAX_BUCKETS} buckets, got {m}")


def identity_args(m: int) -> Tuple:
    """The label arguments of an ids strip: the identity over int32 words,
    which the kernels clamp into ``[0, m)``."""
    _check_m(m)
    return (_SPEC_KINDS[IdentitySpec], KEY_KINDS[torch.int32], m, 0, 0, 0.0, 0.0, None, 0, 0)


def _check_tiles(x: Tensor, shape, what: str, dtypes=tuple(KEY_KINDS)) -> None:
    if x.dtype not in dtypes:
        raise ValueError(f"{what} must be one of {dtypes}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_keys(keys_tiled: Tensor, what: str = "keys",
                dtypes=tuple(KEY_KINDS)) -> Tuple[int, int]:
    if keys_tiled.dim() != 2:
        raise ValueError(f"{what} must be (L, T) tiles, got shape {tuple(keys_tiled.shape)}")
    n_tiles, t = keys_tiled.shape
    _check_tiles(keys_tiled, (n_tiles, t), what, dtypes)
    if not 1 <= t <= MAX_TILE:
        raise ValueError(f"the CUDA kernels take tiles of 1..{MAX_TILE} keys, got {t}")
    return n_tiles, t


def _check_ids(ids_tiled: Tensor, m: int) -> Tuple[int, int]:
    _check_m(m)
    return _check_keys(ids_tiled, "ids", (torch.int32,))


def _check_beside(x: Tensor, ref: Tensor, what: str) -> None:
    """``x`` is a 32-bit (L, T) plane on ``ref``'s device."""
    _check_tiles(x, tuple(ref.shape), what)
    if x.device != ref.device:
        raise ValueError(f"{what} lie on {x.device}, the tiles on {ref.device}")


def _check_bases(g: Tensor, keys_tiled: Tensor, m: int) -> None:
    _check_tiles(g, (keys_tiled.shape[0], m), "G", (torch.int32,))
    if g.device != keys_tiled.device:
        raise ValueError(f"G lies on {g.device}, keys on {keys_tiled.device}")


def _ptr(x: Optional[Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


# ---------------------------------------------------------------------------
# K1: per-tile histograms (prescan)
# ---------------------------------------------------------------------------

def spec_tile_histograms_plain(keys_tiled: Tensor, spec) -> Tensor:
    return common.counts_body(spec.emit(keys_tiled), spec.num_buckets)


def spec_tile_histograms(keys_tiled: Tensor, spec) -> Tensor:
    """(L, T) keys -> (L, m) int32 per-tile histograms; labels in-kernel."""
    if not on_cuda(keys_tiled, "spec_tile_histograms"):
        return spec_tile_histograms_plain(keys_tiled, spec)
    n_tiles, t = _check_keys(keys_tiled)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    hist = torch.empty((n_tiles, spec.num_buckets), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("tile_histograms")
        raise_on(fn(keys_tiled.data_ptr(), hist.data_ptr(), n_tiles, t, *label,
                    stream(keys_tiled)), "tile_histograms")
        spec_tile_histograms.launches += 1
    return hist


# ---------------------------------------------------------------------------
# K3: DMS postscan (element-order destinations)
# ---------------------------------------------------------------------------

def spec_tile_positions_plain(keys_tiled: Tensor, g: Tensor, spec) -> Tensor:
    return common.positions_body(spec.emit(keys_tiled), g, spec.num_buckets)


def spec_tile_positions(keys_tiled: Tensor, g: Tensor, spec) -> Tensor:
    """(L, T) keys + (L, m) int32 bases -> (L, T) int32 destinations
    ``G[b] + rank`` (paper eq. (2)); labels in-kernel."""
    if not on_cuda(keys_tiled, "spec_tile_positions"):
        return spec_tile_positions_plain(keys_tiled, g, spec)
    n_tiles, t = _check_keys(keys_tiled)
    _check_bases(g, keys_tiled, spec.num_buckets)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("tile_positions")
        raise_on(fn(keys_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(), n_tiles, t, *label,
                    stream(keys_tiled)), "tile_positions")
        spec_tile_positions.launches += 1
    return pos


# ---------------------------------------------------------------------------
# K2: fused WMS/BMS postscan + bucket-major reorder
# ---------------------------------------------------------------------------

def spec_fused_postscan_reorder_plain(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], spec
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return common.postscan_body(
        spec.emit(keys_tiled), g, keys_tiled, values_tiled, spec.num_buckets
    )


def spec_fused_postscan_reorder(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], spec
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """(L, T) keys, (L, m) int32 bases [+ (L, T) values] -> (keys_r,
    vals_r, pos_r, perm): the first three stably bucket-major within each
    tile, ``pos_r`` the global destination of each reordered slot, ``perm``
    the element-order destination. Labels in-kernel."""
    if not on_cuda(keys_tiled, "spec_fused_postscan_reorder"):
        return spec_fused_postscan_reorder_plain(keys_tiled, g, values_tiled, spec)
    n_tiles, t = _check_keys(keys_tiled)
    _check_bases(g, keys_tiled, spec.num_buckets)
    if values_tiled is not None:
        _check_beside(values_tiled, keys_tiled, "values")
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    keys_r = torch.empty_like(keys_tiled)
    vals_r = torch.empty_like(values_tiled) if values_tiled is not None else None
    pos_r = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    perm = torch.empty_like(pos_r)
    if n_tiles:
        fn = build.load("fused_postscan_reorder")
        raise_on(fn(keys_tiled.data_ptr(), g.data_ptr(), _ptr(values_tiled), keys_r.data_ptr(),
                    _ptr(vals_r), pos_r.data_ptr(), perm.data_ptr(), n_tiles, t, *label,
                    stream(keys_tiled)), "fused_postscan_reorder")
        spec_fused_postscan_reorder.launches += 1
    return keys_r, vals_r, pos_r, perm


# ---------------------------------------------------------------------------
# Segmented kernels: the combined id cid = seg·m + b (K1s, K2s, K3s)
# ---------------------------------------------------------------------------

def _check_segments(seg_tiled: Tensor, tiles: Tensor, m: int, num_segments: int) -> int:
    """Check the segment strip beside the key or ids tiles and return s·m,
    the width of the histogram row and of G."""
    _check_tiles(seg_tiled, tuple(tiles.shape), "segment ids", (torch.int32,))
    if seg_tiled.device != tiles.device:
        raise ValueError(f"segment ids lie on {seg_tiled.device}, the tiles on {tiles.device}")
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    width = num_segments * m
    if width >= 1 << 31:
        raise ValueError(f"the CUDA kernels take s·m < 2^31 combined buckets, got {width}")
    return width


def seg_spec_tile_histograms_plain(keys_tiled: Tensor, seg_tiled: Tensor, spec,
                                   num_segments: int) -> Tensor:
    return common.seg_counts_body(spec.emit(keys_tiled), seg_tiled, spec.num_buckets,
                                  num_segments)


def seg_spec_tile_histograms(keys_tiled: Tensor, seg_tiled: Tensor, spec,
                             num_segments: int) -> Tensor:
    """(L, T) keys + (L, T) int32 segment ids, non-decreasing along each
    tile -> (L, s·m) int32 histograms of ``cid = seg·m + b``; labels
    in-kernel."""
    if not on_cuda(keys_tiled, "seg_spec_tile_histograms"):
        return seg_spec_tile_histograms_plain(keys_tiled, seg_tiled, spec, num_segments)
    n_tiles, t = _check_keys(keys_tiled)
    width = _check_segments(seg_tiled, keys_tiled, spec.num_buckets, num_segments)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    hist = torch.empty((n_tiles, width), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_histograms")
        raise_on(fn(keys_tiled.data_ptr(), seg_tiled.data_ptr(), hist.data_ptr(), n_tiles, t,
                    num_segments, *label, stream(keys_tiled)), "seg_tile_histograms")
        seg_spec_tile_histograms.launches += 1
    return hist


def seg_spec_tile_positions_plain(keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, spec,
                                  num_segments: int) -> Tensor:
    return common.seg_positions_body(spec.emit(keys_tiled), seg_tiled, g, spec.num_buckets)


def seg_spec_tile_positions(keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, spec,
                            num_segments: int) -> Tensor:
    """(L, T) keys and segment ids + (L, s·m) int32 bases -> (L, T) int32
    destinations ``G[cid] + rank`` (paper eq. (2)); labels in-kernel."""
    if not on_cuda(keys_tiled, "seg_spec_tile_positions"):
        return seg_spec_tile_positions_plain(keys_tiled, seg_tiled, g, spec, num_segments)
    n_tiles, t = _check_keys(keys_tiled)
    width = _check_segments(seg_tiled, keys_tiled, spec.num_buckets, num_segments)
    _check_bases(g, keys_tiled, width)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_positions")
        raise_on(fn(keys_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(),
                    n_tiles, t, num_segments, *label, stream(keys_tiled)), "seg_tile_positions")
        seg_spec_tile_positions.launches += 1
    return pos


def seg_spec_fused_postscan_reorder_plain(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], spec,
    num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return common.seg_postscan_body(
        spec.emit(keys_tiled), seg_tiled, g, keys_tiled, values_tiled, spec.num_buckets,
        num_segments,
    )


def seg_spec_fused_postscan_reorder(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], spec,
    num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """(L, T) keys and segment ids, (L, s·m) int32 bases [+ (L, T) values]
    -> (keys_r, vals_r, pos_r, perm): the contract of
    :func:`spec_fused_postscan_reorder` with the first three stably
    (segment, bucket)-major within each tile. Labels in-kernel."""
    if not on_cuda(keys_tiled, "seg_spec_fused_postscan_reorder"):
        return seg_spec_fused_postscan_reorder_plain(
            keys_tiled, seg_tiled, g, values_tiled, spec, num_segments)
    n_tiles, t = _check_keys(keys_tiled)
    width = _check_segments(seg_tiled, keys_tiled, spec.num_buckets, num_segments)
    _check_bases(g, keys_tiled, width)
    if values_tiled is not None:
        _check_beside(values_tiled, keys_tiled, "values")
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    keys_r = torch.empty_like(keys_tiled)
    vals_r = torch.empty_like(values_tiled) if values_tiled is not None else None
    pos_r = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    perm = torch.empty_like(pos_r)
    if n_tiles:
        fn = build.load("seg_fused_postscan_reorder")
        raise_on(fn(keys_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(),
                    _ptr(values_tiled), keys_r.data_ptr(), _ptr(vals_r), pos_r.data_ptr(),
                    perm.data_ptr(), n_tiles, t, num_segments, *label, stream(keys_tiled)),
                 "seg_fused_postscan_reorder")
        seg_spec_fused_postscan_reorder.launches += 1
    return keys_r, vals_r, pos_r, perm


# ---------------------------------------------------------------------------
# Materialised labels: the int32 ids strip (K1, K2, K3, K1s, K2s, K3s on ids)
# ---------------------------------------------------------------------------

def clamp_ids(ids: Tensor, m: int) -> Tensor:
    """The label of each id as the kernels read it: ``min(max(id, 0), m-1)``."""
    return ids.clamp(0, m - 1)


def tile_histograms_plain(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    return common.counts_body(clamp_ids(ids_tiled, num_buckets), num_buckets)


def tile_histograms(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    """(L, T) int32 ids -> (L, m) int32 per-tile histograms: K1 on the ids
    strip under the identity label."""
    if not on_cuda(ids_tiled, "tile_histograms"):
        return tile_histograms_plain(ids_tiled, num_buckets)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    hist = torch.empty((n_tiles, num_buckets), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("tile_histograms")
        raise_on(fn(ids_tiled.data_ptr(), hist.data_ptr(), n_tiles, t,
                    *identity_args(num_buckets), stream(ids_tiled)), "tile_histograms")
        tile_histograms.launches += 1
    return hist


def tile_positions_plain(ids_tiled: Tensor, g: Tensor, num_buckets: int) -> Tensor:
    return common.positions_body(clamp_ids(ids_tiled, num_buckets), g, num_buckets)


def tile_positions(ids_tiled: Tensor, g: Tensor, num_buckets: int) -> Tensor:
    """(L, T) int32 ids + (L, m) int32 bases -> (L, T) int32 destinations
    ``G[b] + rank``: K3 on the ids strip."""
    if not on_cuda(ids_tiled, "tile_positions"):
        return tile_positions_plain(ids_tiled, g, num_buckets)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    _check_bases(g, ids_tiled, num_buckets)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("tile_positions")
        raise_on(fn(ids_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(), n_tiles, t,
                    *identity_args(num_buckets), stream(ids_tiled)), "tile_positions")
        tile_positions.launches += 1
    return pos


def fused_postscan_reorder_plain(
    ids_tiled: Tensor, g: Tensor, keys_tiled: Tensor, values_tiled: Optional[Tensor],
    num_buckets: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return common.postscan_body(clamp_ids(ids_tiled, num_buckets), g, keys_tiled, values_tiled,
                                num_buckets)


def fused_postscan_reorder(
    ids_tiled: Tensor, g: Tensor, keys_tiled: Tensor, values_tiled: Optional[Tensor],
    num_buckets: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """(L, T) int32 ids, (L, m) int32 bases, (L, T) keys [+ values] ->
    (keys_r, vals_r, pos_r, perm), the contract of
    :func:`spec_fused_postscan_reorder` with the labels read from the ids
    strip: K2's ids entry point."""
    if not on_cuda(ids_tiled, "fused_postscan_reorder"):
        return fused_postscan_reorder_plain(ids_tiled, g, keys_tiled, values_tiled, num_buckets)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    _check_bases(g, ids_tiled, num_buckets)
    _check_beside(keys_tiled, ids_tiled, "keys")
    if values_tiled is not None:
        _check_beside(values_tiled, ids_tiled, "values")
    keys_r = torch.empty_like(keys_tiled)
    vals_r = torch.empty_like(values_tiled) if values_tiled is not None else None
    pos_r = torch.empty((n_tiles, t), dtype=torch.int32, device=ids_tiled.device)
    perm = torch.empty_like(pos_r)
    if n_tiles:
        fn = build.load("fused_postscan_reorder_ids")
        raise_on(fn(ids_tiled.data_ptr(), g.data_ptr(), keys_tiled.data_ptr(), _ptr(values_tiled),
                    keys_r.data_ptr(), _ptr(vals_r), pos_r.data_ptr(), perm.data_ptr(), n_tiles,
                    t, num_buckets, stream(ids_tiled)), "fused_postscan_reorder (ids)")
        fused_postscan_reorder.launches += 1
    return keys_r, vals_r, pos_r, perm


def seg_tile_histograms_plain(ids_tiled: Tensor, seg_tiled: Tensor, num_buckets: int,
                              num_segments: int) -> Tensor:
    return common.seg_counts_body(clamp_ids(ids_tiled, num_buckets), seg_tiled, num_buckets,
                                  num_segments)


def seg_tile_histograms(ids_tiled: Tensor, seg_tiled: Tensor, num_buckets: int,
                        num_segments: int) -> Tensor:
    """(L, T) int32 ids + (L, T) int32 segment ids, non-decreasing along
    each tile -> (L, s·m) int32 histograms of ``cid = seg·m + id``: K1s on
    the ids strip."""
    if not on_cuda(ids_tiled, "seg_tile_histograms"):
        return seg_tile_histograms_plain(ids_tiled, seg_tiled, num_buckets, num_segments)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    width = _check_segments(seg_tiled, ids_tiled, num_buckets, num_segments)
    hist = torch.empty((n_tiles, width), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_histograms")
        raise_on(fn(ids_tiled.data_ptr(), seg_tiled.data_ptr(), hist.data_ptr(), n_tiles, t,
                    num_segments, *identity_args(num_buckets), stream(ids_tiled)),
                 "seg_tile_histograms")
        seg_tile_histograms.launches += 1
    return hist


def seg_tile_positions_plain(ids_tiled: Tensor, seg_tiled: Tensor, g: Tensor, num_buckets: int,
                             num_segments: int) -> Tensor:
    return common.seg_positions_body(clamp_ids(ids_tiled, num_buckets), seg_tiled, g,
                                     num_buckets)


def seg_tile_positions(ids_tiled: Tensor, seg_tiled: Tensor, g: Tensor, num_buckets: int,
                       num_segments: int) -> Tensor:
    """(L, T) int32 ids and segment ids + (L, s·m) int32 bases -> (L, T)
    int32 destinations ``G[cid] + rank``: K3s on the ids strip."""
    if not on_cuda(ids_tiled, "seg_tile_positions"):
        return seg_tile_positions_plain(ids_tiled, seg_tiled, g, num_buckets, num_segments)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    width = _check_segments(seg_tiled, ids_tiled, num_buckets, num_segments)
    _check_bases(g, ids_tiled, width)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_positions")
        raise_on(fn(ids_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(),
                    n_tiles, t, num_segments, *identity_args(num_buckets), stream(ids_tiled)),
                 "seg_tile_positions")
        seg_tile_positions.launches += 1
    return pos


def seg_fused_postscan_reorder_plain(
    ids_tiled: Tensor, seg_tiled: Tensor, g: Tensor, keys_tiled: Tensor,
    values_tiled: Optional[Tensor], num_buckets: int, num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return common.seg_postscan_body(clamp_ids(ids_tiled, num_buckets), seg_tiled, g, keys_tiled,
                                    values_tiled, num_buckets, num_segments)


def seg_fused_postscan_reorder(
    ids_tiled: Tensor, seg_tiled: Tensor, g: Tensor, keys_tiled: Tensor,
    values_tiled: Optional[Tensor], num_buckets: int, num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """(L, T) int32 ids and segment ids, (L, s·m) int32 bases, (L, T) keys
    [+ values] -> the contract of :func:`seg_spec_fused_postscan_reorder`
    with the labels read from the ids strip: K2s's ids entry point."""
    if not on_cuda(ids_tiled, "seg_fused_postscan_reorder"):
        return seg_fused_postscan_reorder_plain(ids_tiled, seg_tiled, g, keys_tiled, values_tiled,
                                                num_buckets, num_segments)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    width = _check_segments(seg_tiled, ids_tiled, num_buckets, num_segments)
    _check_bases(g, ids_tiled, width)
    _check_beside(keys_tiled, ids_tiled, "keys")
    if values_tiled is not None:
        _check_beside(values_tiled, ids_tiled, "values")
    keys_r = torch.empty_like(keys_tiled)
    vals_r = torch.empty_like(values_tiled) if values_tiled is not None else None
    pos_r = torch.empty((n_tiles, t), dtype=torch.int32, device=ids_tiled.device)
    perm = torch.empty_like(pos_r)
    if n_tiles:
        fn = build.load("seg_fused_postscan_reorder_ids")
        raise_on(fn(ids_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(),
                    keys_tiled.data_ptr(), _ptr(values_tiled), keys_r.data_ptr(), _ptr(vals_r),
                    pos_r.data_ptr(), perm.data_ptr(), n_tiles, t, num_segments, num_buckets,
                    stream(ids_tiled)), "seg_fused_postscan_reorder (ids)")
        seg_fused_postscan_reorder.launches += 1
    return keys_r, vals_r, pos_r, perm


# ---------------------------------------------------------------------------
# B10: the standalone tile reorder of the unfused baseline
# ---------------------------------------------------------------------------

def tile_reorder_plain(
    ids_tiled: Tensor, keys_tiled: Tensor, values_tiled: Optional[Tensor], num_buckets: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    return common.reorder_body(clamp_ids(ids_tiled, num_buckets), keys_tiled, values_tiled,
                               num_buckets)


def tile_reorder(
    ids_tiled: Tensor, keys_tiled: Tensor, values_tiled: Optional[Tensor], num_buckets: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """(L, T) int32 ids, (L, T) keys [+ values] -> (keys_r, vals_r, dest):
    keys and values stably bucket-major within each tile, and ``dest``
    (L, T) int32, each element's destination inside its tile. No bases G,
    no global destination (B10)."""
    if not on_cuda(ids_tiled, "tile_reorder"):
        return tile_reorder_plain(ids_tiled, keys_tiled, values_tiled, num_buckets)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    _check_beside(keys_tiled, ids_tiled, "keys")
    if values_tiled is not None:
        _check_beside(values_tiled, ids_tiled, "values")
    keys_r = torch.empty_like(keys_tiled)
    vals_r = torch.empty_like(values_tiled) if values_tiled is not None else None
    dest = torch.empty((n_tiles, t), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("tile_reorder")
        raise_on(fn(ids_tiled.data_ptr(), keys_tiled.data_ptr(), _ptr(values_tiled),
                    keys_r.data_ptr(), _ptr(vals_r), dest.data_ptr(), n_tiles, t, num_buckets,
                    stream(ids_tiled)), "tile_reorder")
        tile_reorder.launches += 1
    return keys_r, vals_r, dest


# ---------------------------------------------------------------------------
# The labels of a declarative spec, written out
# ---------------------------------------------------------------------------

def spec_bucket_ids_plain(keys_tiled: Tensor, spec) -> Tensor:
    return clamp_ids(spec.emit(keys_tiled), spec.num_buckets)


def spec_bucket_ids(keys_tiled: Tensor, spec) -> Tensor:
    """(L, T) keys -> (L, T) int32 labels of a declarative spec, bitwise
    the labels K1-K3 compute in-register."""
    if not on_cuda(keys_tiled, "spec_bucket_ids"):
        return spec_bucket_ids_plain(keys_tiled, spec)
    n_tiles, t = _check_keys(keys_tiled)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    ids = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("spec_bucket_ids")
        raise_on(fn(keys_tiled.data_ptr(), ids.data_ptr(), n_tiles, t, *label,
                    stream(keys_tiled)), "spec_bucket_ids")
        spec_bucket_ids.launches += 1
    return ids


# ---------------------------------------------------------------------------
# The packed family: K1p, K3p, K2p over {spec | ids} × {flat | segmented}
# ---------------------------------------------------------------------------

PACKED_BITS = common.DEFAULT_PACKED_BITS     # the only counter width the kernels take


def _packed_labels(tiled: Tensor, seg_tiled: Optional[Tensor], num_buckets: Optional[int], spec,
                   num_segments: int) -> Tuple[Tensor, int]:
    """The plain versions' (combined) label strip and its width m_eff: the
    spec's labels, or the ids, clamped into [0, m) as the kernels read
    them, plus ``seg·m`` with a segment strip."""
    m = _packed_m(num_buckets, spec)
    _check_flat_segments(seg_tiled, num_segments)
    ids = clamp_ids(spec.emit(tiled) if spec is not None else tiled, m)
    if seg_tiled is not None:
        ids = common.combined_ids(ids, seg_tiled, m)
    return ids, m * num_segments


def _check_flat_segments(seg_tiled: Optional[Tensor], num_segments: int) -> None:
    if seg_tiled is None and num_segments != 1:
        raise ValueError(f"num_segments={num_segments} needs a segment strip")


def _packed_keys(tiled: Tensor, keys_tiled: Optional[Tensor], spec) -> Tensor:
    """The words K2p moves: the key strip itself under a spec, else the
    keys beside the ids strip."""
    if spec is not None:
        if keys_tiled is not None:
            raise ValueError("packed_fused_postscan_reorder: with a spec the keys are the strip "
                             "itself; pass no keys_tiled")
        return tiled
    if keys_tiled is None:
        raise ValueError("packed_fused_postscan_reorder: an ids strip needs keys_tiled")
    return keys_tiled


def _packed_m(num_buckets: Optional[int], spec) -> int:
    if spec is not None:
        return spec.num_buckets
    if num_buckets is None:
        raise ValueError("an ids strip needs num_buckets")
    return num_buckets


def _packed_layout(t: int, m_eff: int, bits: Optional[int],
                   subtile: Optional[int]) -> common.PackedLayout:
    """The guarded layout of a tile; ``None`` takes the default width and
    the auto subtile, as in the JAX doors."""
    return common.packed_layout(t, m_eff, PACKED_BITS if bits is None else bits, subtile)


def _packed_launch_args(tiled: Tensor, seg_tiled: Optional[Tensor], num_buckets: Optional[int],
                        spec, num_segments: int, bits, subtile):
    """Check the CUDA launch of one packed wrapper and return (n_tiles, T,
    width, subtile, keys, ids, label): ``keys``/``ids`` are the strip as
    the key or the ids argument (the other None), ``label`` the ten label
    arguments."""
    m = _packed_m(num_buckets, spec)
    if spec is None:
        n_tiles, t = _check_ids(tiled, m)
        keys, ids, label = None, tiled, identity_args(m)
    else:
        n_tiles, t = _check_keys(tiled)
        keys, ids, label = tiled, None, label_args(spec, tiled.dtype, tiled.device)
    _check_flat_segments(seg_tiled, num_segments)
    width = m if seg_tiled is None else _check_segments(seg_tiled, tiled, m, num_segments)
    layout = _packed_layout(t, width, bits, subtile)
    if layout.bits != PACKED_BITS:
        raise ValueError(f"the CUDA packed kernels take {PACKED_BITS}-bit counters, got bits={bits}")
    return n_tiles, t, width, layout.subtile, keys, ids, label


def packed_tile_histograms_plain(
    tiled: Tensor, seg_tiled: Optional[Tensor] = None, *, num_buckets: Optional[int] = None,
    spec=None, num_segments: int = 1, bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tensor:
    ids, m_eff = _packed_labels(tiled, seg_tiled, num_buckets, spec, num_segments)
    return common.packed_counts(ids, _packed_layout(ids.shape[1], m_eff, bits, subtile))


def packed_tile_histograms(
    tiled: Tensor, seg_tiled: Optional[Tensor] = None, *, num_buckets: Optional[int] = None,
    spec=None, num_segments: int = 1, bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tensor:
    """(L, T) keys (labels from ``spec`` in the kernel) or int32 ids (with
    ``num_buckets``) [+ (L, T) segment ids, non-decreasing along each tile]
    -> (L, s·m) int32 tile histograms from packed 8-bit counters (K1p)."""
    if not on_cuda(tiled, "packed_tile_histograms"):
        return packed_tile_histograms_plain(
            tiled, seg_tiled, num_buckets=num_buckets, spec=spec, num_segments=num_segments,
            bits=bits, subtile=subtile)
    n_tiles, t, width, sub, keys, ids, label = _packed_launch_args(
        tiled, seg_tiled, num_buckets, spec, num_segments, bits, subtile)
    hist = torch.empty((n_tiles, width), dtype=torch.int32, device=tiled.device)
    if n_tiles:
        fn = build.load("packed_tile_histograms")
        raise_on(fn(_ptr(keys), _ptr(ids), _ptr(seg_tiled), hist.data_ptr(), n_tiles, t,
                    num_segments, sub, *label, stream(tiled)), "packed_tile_histograms")
        packed_tile_histograms.launches += 1
    return hist


def packed_tile_positions_plain(
    tiled: Tensor, g: Tensor, seg_tiled: Optional[Tensor] = None, *,
    num_buckets: Optional[int] = None, spec=None, num_segments: int = 1,
    bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tensor:
    ids, m_eff = _packed_labels(tiled, seg_tiled, num_buckets, spec, num_segments)
    return common.packed_positions_body(ids, g, _packed_layout(ids.shape[1], m_eff, bits, subtile))


def packed_tile_positions(
    tiled: Tensor, g: Tensor, seg_tiled: Optional[Tensor] = None, *,
    num_buckets: Optional[int] = None, spec=None, num_segments: int = 1,
    bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tensor:
    """(L, T) keys or ids [+ segment ids] and (L, s·m) int32 bases ->
    (L, T) int32 destinations ``G[cid] + rank`` (paper eq. (2)) on the
    two-level packed rank (K3p)."""
    if not on_cuda(tiled, "packed_tile_positions"):
        return packed_tile_positions_plain(
            tiled, g, seg_tiled, num_buckets=num_buckets, spec=spec, num_segments=num_segments,
            bits=bits, subtile=subtile)
    n_tiles, t, width, sub, keys, ids, label = _packed_launch_args(
        tiled, seg_tiled, num_buckets, spec, num_segments, bits, subtile)
    _check_bases(g, tiled, width)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=tiled.device)
    if n_tiles:
        fn = build.load("packed_tile_positions")
        raise_on(fn(_ptr(keys), _ptr(ids), _ptr(seg_tiled), g.data_ptr(), pos.data_ptr(),
                    n_tiles, t, num_segments, sub, *label, stream(tiled)),
                 "packed_tile_positions")
        packed_tile_positions.launches += 1
    return pos


def packed_fused_postscan_reorder_plain(
    tiled: Tensor, g: Tensor, keys_tiled: Optional[Tensor] = None,
    values_tiled: Optional[Tensor] = None, seg_tiled: Optional[Tensor] = None, *,
    num_buckets: Optional[int] = None, spec=None, num_segments: int = 1,
    bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    keys = _packed_keys(tiled, keys_tiled, spec)
    ids, m_eff = _packed_labels(tiled, seg_tiled, num_buckets, spec, num_segments)
    return common.packed_postscan_body(ids, g, keys, values_tiled,
                                       _packed_layout(ids.shape[1], m_eff, bits, subtile))


def packed_fused_postscan_reorder(
    tiled: Tensor, g: Tensor, keys_tiled: Optional[Tensor] = None,
    values_tiled: Optional[Tensor] = None, seg_tiled: Optional[Tensor] = None, *,
    num_buckets: Optional[int] = None, spec=None, num_segments: int = 1,
    bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """The reorder contract of :func:`spec_fused_postscan_reorder` (and its
    segmented form) on the two-level packed rank (K2p). ``tiled`` is the key
    strip (labels from ``spec``) or an ids strip, with the words to move in
    ``keys_tiled`` beside it."""
    if not on_cuda(tiled, "packed_fused_postscan_reorder"):
        return packed_fused_postscan_reorder_plain(
            tiled, g, keys_tiled, values_tiled, seg_tiled, num_buckets=num_buckets, spec=spec,
            num_segments=num_segments, bits=bits, subtile=subtile)
    n_tiles, t, width, sub, keys, ids, label = _packed_launch_args(
        tiled, seg_tiled, num_buckets, spec, num_segments, bits, subtile)
    _check_bases(g, tiled, width)
    keys = _packed_keys(tiled, keys_tiled, spec)
    _check_beside(keys, tiled, "keys")
    if values_tiled is not None:
        _check_beside(values_tiled, tiled, "values")
    keys_r = torch.empty_like(keys)
    vals_r = torch.empty_like(values_tiled) if values_tiled is not None else None
    pos_r = torch.empty((n_tiles, t), dtype=torch.int32, device=tiled.device)
    perm = torch.empty_like(pos_r)
    if n_tiles:
        fn = build.load("packed_fused_postscan_reorder")
        raise_on(fn(keys.data_ptr(), _ptr(ids), _ptr(seg_tiled), g.data_ptr(),
                    _ptr(values_tiled), keys_r.data_ptr(), _ptr(vals_r), pos_r.data_ptr(),
                    perm.data_ptr(), n_tiles, t, num_segments, sub, *label, stream(tiled)),
                 "packed_fused_postscan_reorder")
        packed_fused_postscan_reorder.launches += 1
    return keys_r, vals_r, pos_r, perm


# ---------------------------------------------------------------------------
# The fused two-digit family: K1f, K3f, K2f over {flat | segmented} ×
# {onehot | packed stage rank}
# ---------------------------------------------------------------------------

MAX_PAIR_BITS = 16        # the widest pair the kernels take (m² = 65536)
MAX_SUB_BITS = 8          # a stage of the sweep has 2^sub <= MAX_BUCKETS buckets
# The kernels' stage width when the plan names none: 8-bit stages (2 a
# 16-bit pair) against the JAX default of 4 (4 stages), because the H100's
# warp-ballot rank barely grows with the bucket count. Measured at F1's
# shapes (2^25 keys in tiles of 8192): K2f key-value 2.5706 ms at 8 against
# 2.9508 at 4, K3f 1.9733 against 2.3833, the packed stage rank alike
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6, the fused-radix findings);
# chip_smoke.py's fused-pair autotune grid picks 8 again. Every width gives
# the same bits.
CUDA_SUB_BITS = 8


def _fused2_check_spec(keys_tiled: Tensor, spec) -> None:
    if not isinstance(spec, BitfieldSpec):
        raise ValueError(f"the fused2 kernels take the pair's BitfieldSpec, got {type(spec).__name__}")
    spec._check_integer(keys_tiled.dtype)


def _fused2_launch_args(keys_tiled: Tensor, seg_tiled: Optional[Tensor], spec,
                        num_segments: int, family: str = "onehot",
                        sub_bits: Optional[int] = None) -> Tuple[int, int, int, int]:
    """Check a CUDA launch of one fused2 wrapper and return (n_tiles, T,
    width s·m², the stage width)."""
    _fused2_check_spec(keys_tiled, spec)
    n_tiles, t = _check_keys(keys_tiled, dtypes=(torch.int32, torch.uint32))
    if not 1 <= spec.bits <= MAX_PAIR_BITS or spec.shift + spec.bits > 32:
        raise ValueError(f"the CUDA fused2 kernels take pairs of 1..{MAX_PAIR_BITS} bits within the "
                         f"32-bit key, got shift={spec.shift}, bits={spec.bits}")
    sub = CUDA_SUB_BITS if sub_bits is None else sub_bits
    if not 1 <= sub <= MAX_SUB_BITS:
        raise ValueError(f"the CUDA fused2 kernels take stages of 1..{MAX_SUB_BITS} bits, got "
                         f"sub_bits={sub_bits}")
    if family not in ("onehot", "packed"):
        raise ValueError(f"unknown kernel family {family!r}; expected one of ('onehot', 'packed')")
    _check_flat_segments(seg_tiled, num_segments)
    m2 = spec.num_buckets
    width = m2 if seg_tiled is None else _check_segments(seg_tiled, keys_tiled, m2, num_segments)
    return n_tiles, t, width, sub


def fused2_tile_histograms_plain(keys_tiled: Tensor, seg_tiled: Optional[Tensor] = None, *, spec,
                                 num_segments: int = 1) -> Tensor:
    _fused2_check_spec(keys_tiled, spec)
    _check_flat_segments(seg_tiled, num_segments)
    return common.fused2_counts_body(keys_tiled, spec.shift, spec.bits, seg_tiled, num_segments)


def fused2_tile_histograms(keys_tiled: Tensor, seg_tiled: Optional[Tensor] = None, *, spec,
                           num_segments: int = 1) -> Tensor:
    """(L, T) integer keys [+ (L, T) segment ids, non-decreasing along each
    tile] -> (L, s·m²) int32 histograms of the cell ``seg·m² + pair``, the
    pair the ``spec.bits`` wide BitfieldSpec digit (K1f)."""
    if not on_cuda(keys_tiled, "fused2_tile_histograms"):
        return fused2_tile_histograms_plain(keys_tiled, seg_tiled, spec=spec,
                                            num_segments=num_segments)
    n_tiles, t, width, _ = _fused2_launch_args(keys_tiled, seg_tiled, spec, num_segments)
    hist = torch.empty((n_tiles, width), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("fused2_tile_histograms")
        raise_on(fn(keys_tiled.data_ptr(), _ptr(seg_tiled), hist.data_ptr(), n_tiles, t,
                    num_segments, spec.shift, spec.bits, stream(keys_tiled)),
                 "fused2_tile_histograms")
        fused2_tile_histograms.launches += 1
    return hist


def fused2_tile_positions_plain(
    keys_tiled: Tensor, g: Tensor, seg_tiled: Optional[Tensor] = None, *, spec, split: int,
    num_segments: int = 1, family: str = "onehot", sub_bits: Optional[int] = None,
) -> Tensor:
    _fused2_check_spec(keys_tiled, spec)
    return common.fused2_positions_body(
        keys_tiled, g, spec.shift, split, spec.bits, seg=seg_tiled, num_segments=num_segments,
        family=family, sub_bits=CUDA_SUB_BITS if sub_bits is None else sub_bits)


def fused2_tile_positions(
    keys_tiled: Tensor, g: Tensor, seg_tiled: Optional[Tensor] = None, *, spec, split: int,
    num_segments: int = 1, family: str = "onehot", sub_bits: Optional[int] = None,
) -> Tensor:
    """(L, T) integer keys [+ segment ids] and (L, s·m²) int32 bases ->
    (L, T) int32 element-order destinations ``G[seg·m² + pair] + rank``
    over the pair (K3f). The result depends on neither ``split``,
    ``family`` nor ``sub_bits``."""
    if not on_cuda(keys_tiled, "fused2_tile_positions"):
        return fused2_tile_positions_plain(
            keys_tiled, g, seg_tiled, spec=spec, split=split, num_segments=num_segments,
            family=family, sub_bits=sub_bits)
    n_tiles, t, width, sub = _fused2_launch_args(keys_tiled, seg_tiled, spec, num_segments,
                                                 family, sub_bits)
    _check_bases(g, keys_tiled, width)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("fused2_tile_positions")
        raise_on(fn(keys_tiled.data_ptr(), _ptr(seg_tiled), g.data_ptr(), pos.data_ptr(), n_tiles,
                    t, num_segments, spec.shift, spec.bits, sub, int(family == "packed"),
                    stream(keys_tiled)), "fused2_tile_positions")
        fused2_tile_positions.launches += 1
    return pos


def fused2_fused_postscan_reorder_plain(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor] = None,
    seg_tiled: Optional[Tensor] = None, *, spec, split: int, num_segments: int = 1,
    family: str = "onehot", sub_bits: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    _fused2_check_spec(keys_tiled, spec)
    return common.fused2_postscan_body(
        keys_tiled, g, values_tiled, spec.shift, split, spec.bits, seg=seg_tiled,
        num_segments=num_segments, family=family,
        sub_bits=CUDA_SUB_BITS if sub_bits is None else sub_bits)


def fused2_fused_postscan_reorder(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor] = None,
    seg_tiled: Optional[Tensor] = None, *, spec, split: int, num_segments: int = 1,
    family: str = "onehot", sub_bits: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """(L, T) integer keys, (L, s·m²) int32 bases [+ (L, T) values] [+
    segment ids] -> (keys_r, vals_r, pos_r, perm), the reorder contract of
    :func:`spec_fused_postscan_reorder` over the pair: two radix digits a
    tile, the first three stably (seg, pair)-major (K2f)."""
    if not on_cuda(keys_tiled, "fused2_fused_postscan_reorder"):
        return fused2_fused_postscan_reorder_plain(
            keys_tiled, g, values_tiled, seg_tiled, spec=spec, split=split,
            num_segments=num_segments, family=family, sub_bits=sub_bits)
    n_tiles, t, width, sub = _fused2_launch_args(keys_tiled, seg_tiled, spec, num_segments,
                                                 family, sub_bits)
    _check_bases(g, keys_tiled, width)
    if values_tiled is not None:
        _check_beside(values_tiled, keys_tiled, "values")
    keys_r = torch.empty_like(keys_tiled)
    vals_r = torch.empty_like(values_tiled) if values_tiled is not None else None
    pos_r = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    perm = torch.empty_like(pos_r)
    if n_tiles:
        fn = build.load("fused2_fused_postscan_reorder")
        raise_on(fn(keys_tiled.data_ptr(), _ptr(seg_tiled), g.data_ptr(), _ptr(values_tiled),
                    keys_r.data_ptr(), _ptr(vals_r), pos_r.data_ptr(), perm.data_ptr(), n_tiles,
                    t, num_segments, spec.shift, spec.bits, sub, int(family == "packed"),
                    stream(keys_tiled)), "fused2_fused_postscan_reorder")
        fused2_fused_postscan_reorder.launches += 1
    return keys_r, vals_r, pos_r, perm


# ---------------------------------------------------------------------------
# Launch reports: what a kernel's launcher would launch with, nothing launched
# ---------------------------------------------------------------------------

_PLANE = 1 << 12          # an aligned address standing for a plane: never read


def launch_report(kernel: str, tile: int, spec, *, num_segments: Optional[int] = None,
                  key_value: bool = False, family: str = "onehot",
                  key_dtype: torch.dtype = torch.int32) -> dict:
    """The launcher's (stages, shared bytes, blocks an SM, registers, static
    shared bytes, threads) for the kernel wrapper ``kernel`` over one tile
    of ``tile`` keys (:func:`repro_torch.kernels.build.launch_report`): the
    card's own answer, which the shared-memory model of
    ``core/pipeline/tiles.py`` is held against. ``spec`` gives the labels
    (the pair's ``BitfieldSpec`` for the fused2 kernels); the ids wrappers
    and ``family="packed_ids"`` read an ids strip of ``spec.num_buckets``
    ids. Counts no launch."""
    p, s = _PLANE, num_segments or 1
    seg = p if num_segments is not None else None
    vals = p if key_value else None
    m = spec.num_buckets
    ids = kernel in ("tile_histograms", "tile_positions", "fused_postscan_reorder",
                     "seg_tile_histograms", "seg_tile_positions", "seg_fused_postscan_reorder")
    label = identity_args(m) if ids else None
    if kernel.startswith("fused2_"):
        sub = CUDA_SUB_BITS
        packed = int(family == "packed")
        tail = (1, tile, s, spec.shift, spec.bits)
        args = {
            "fused2_tile_histograms": (p, seg, p) + tail,
            "fused2_tile_positions": (p, seg, p, p) + tail + (sub, packed),
            "fused2_fused_postscan_reorder": (p, seg, p, vals, p, vals, p, p) + tail + (sub, packed),
        }[kernel]
        return build.launch_report(kernel, *args, None)
    if kernel.startswith("packed_"):
        on_ids = family == "packed_ids"
        keys, idp = (None, p) if on_ids else (p, None)
        label = identity_args(m) if on_ids else label_args(spec, key_dtype, torch.device("cpu"))
        sub = _packed_layout(tile, m * s, None, None).subtile
        args = {
            "packed_tile_histograms": (keys, idp, seg, p, 1, tile, s, sub),
            "packed_tile_positions": (keys, idp, seg, p, p, 1, tile, s, sub),
            "packed_fused_postscan_reorder": (p, idp, seg, p, vals, p, vals, p, p, 1, tile, s,
                                              sub),
        }[kernel]
        return build.launch_report(kernel, *args, *label, None)
    label = label or label_args(spec, key_dtype, torch.device("cpu"))
    entry, args = {
        "spec_tile_histograms": ("tile_histograms", (p, p, 1, tile) + label),
        "tile_histograms": ("tile_histograms", (p, p, 1, tile) + label),
        "spec_tile_positions": ("tile_positions", (p, p, p, 1, tile) + label),
        "tile_positions": ("tile_positions", (p, p, p, 1, tile) + label),
        "spec_fused_postscan_reorder": ("fused_postscan_reorder",
                                        (p, p, vals, p, vals, p, p, 1, tile) + label),
        "fused_postscan_reorder": ("fused_postscan_reorder_ids",
                                   (p, p, p, vals, p, vals, p, p, 1, tile, m)),
        "seg_spec_tile_histograms": ("seg_tile_histograms", (p, p, p, 1, tile, s) + label),
        "seg_tile_histograms": ("seg_tile_histograms", (p, p, p, 1, tile, s) + label),
        "seg_spec_tile_positions": ("seg_tile_positions", (p, p, p, p, 1, tile, s) + label),
        "seg_tile_positions": ("seg_tile_positions", (p, p, p, p, 1, tile, s) + label),
        "seg_spec_fused_postscan_reorder": ("seg_fused_postscan_reorder",
                                            (p, p, p, vals, p, vals, p, p, 1, tile, s) + label),
        "seg_fused_postscan_reorder": ("seg_fused_postscan_reorder_ids",
                                       (p, p, p, p, vals, p, vals, p, p, 1, tile, s, m)),
    }[kernel]
    return build.launch_report(entry, *args, None)
