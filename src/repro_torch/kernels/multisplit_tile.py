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

The label of an id is ``min(max(id, 0), m - 1)`` in every kernel and plain
version: an id outside ``[0, m)`` is outside the contract, as an
``IdentitySpec`` key is, and the clamp only keeps it from writing out of
bounds.

Dispatch: a wrapper runs its plain version (``*_plain``, pure torch, the
same function) only for a tensor on the CPU. For a CUDA tensor it launches
the kernel on the current stream, checks the C function's return code
(``cudaGetLastError()`` after the launch) and raises on any error; a failed
build raises too. Nothing falls back. Each wrapper counts its launches in
its ``launches`` attribute, incremented only where the kernel launches.
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

Tensor = torch.Tensor

MAX_BUCKETS = 256         # one thread per bucket in the kernels' scans
MAX_TILE = 8192           # K2s keeps six T-word planes in shared memory (206 KB)

KEY_KINDS = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}
_SPEC_KINDS = {DeltaSpec: 0, IdentitySpec: 1, BitfieldSpec: 2, RangeSpec: 3, EvenSpec: 4}
_NP_PLANE = {torch.int32: np.int32, torch.uint32: np.uint32, torch.float32: np.float32}


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


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


def _on_cuda(x: Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: tensors must lie on the CPU or a CUDA device, got {x.device}")


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


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise KernelLaunchError(f"{kernel} kernel launch failed with CUDA error {err}")


def _ptr(x: Optional[Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


# ---------------------------------------------------------------------------
# K1: per-tile histograms (prescan)
# ---------------------------------------------------------------------------

def spec_tile_histograms_plain(keys_tiled: Tensor, spec) -> Tensor:
    return common.counts_body(spec.emit(keys_tiled), spec.num_buckets)


def spec_tile_histograms(keys_tiled: Tensor, spec) -> Tensor:
    """(L, T) keys -> (L, m) int32 per-tile histograms; labels in-kernel."""
    if not _on_cuda(keys_tiled, "spec_tile_histograms"):
        return spec_tile_histograms_plain(keys_tiled, spec)
    n_tiles, t = _check_keys(keys_tiled)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    hist = torch.empty((n_tiles, spec.num_buckets), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("tile_histograms")
        _raise_on(fn(keys_tiled.data_ptr(), hist.data_ptr(), n_tiles, t, *label,
                     _stream(keys_tiled)), "tile_histograms")
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
    if not _on_cuda(keys_tiled, "spec_tile_positions"):
        return spec_tile_positions_plain(keys_tiled, g, spec)
    n_tiles, t = _check_keys(keys_tiled)
    _check_bases(g, keys_tiled, spec.num_buckets)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("tile_positions")
        _raise_on(fn(keys_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(), n_tiles, t, *label,
                     _stream(keys_tiled)), "tile_positions")
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
    if not _on_cuda(keys_tiled, "spec_fused_postscan_reorder"):
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
        _raise_on(fn(keys_tiled.data_ptr(), g.data_ptr(), _ptr(values_tiled), keys_r.data_ptr(),
                     _ptr(vals_r), pos_r.data_ptr(), perm.data_ptr(), n_tiles, t, *label,
                     _stream(keys_tiled)), "fused_postscan_reorder")
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
    if not _on_cuda(keys_tiled, "seg_spec_tile_histograms"):
        return seg_spec_tile_histograms_plain(keys_tiled, seg_tiled, spec, num_segments)
    n_tiles, t = _check_keys(keys_tiled)
    width = _check_segments(seg_tiled, keys_tiled, spec.num_buckets, num_segments)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    hist = torch.empty((n_tiles, width), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_histograms")
        _raise_on(fn(keys_tiled.data_ptr(), seg_tiled.data_ptr(), hist.data_ptr(), n_tiles, t,
                     num_segments, *label, _stream(keys_tiled)), "seg_tile_histograms")
        seg_spec_tile_histograms.launches += 1
    return hist


def seg_spec_tile_positions_plain(keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, spec,
                                  num_segments: int) -> Tensor:
    return common.seg_positions_body(spec.emit(keys_tiled), seg_tiled, g, spec.num_buckets)


def seg_spec_tile_positions(keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, spec,
                            num_segments: int) -> Tensor:
    """(L, T) keys and segment ids + (L, s·m) int32 bases -> (L, T) int32
    destinations ``G[cid] + rank`` (paper eq. (2)); labels in-kernel."""
    if not _on_cuda(keys_tiled, "seg_spec_tile_positions"):
        return seg_spec_tile_positions_plain(keys_tiled, seg_tiled, g, spec, num_segments)
    n_tiles, t = _check_keys(keys_tiled)
    width = _check_segments(seg_tiled, keys_tiled, spec.num_buckets, num_segments)
    _check_bases(g, keys_tiled, width)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_positions")
        _raise_on(fn(keys_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(),
                     n_tiles, t, num_segments, *label, _stream(keys_tiled)), "seg_tile_positions")
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
    if not _on_cuda(keys_tiled, "seg_spec_fused_postscan_reorder"):
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
        _raise_on(fn(keys_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(),
                     _ptr(values_tiled), keys_r.data_ptr(), _ptr(vals_r), pos_r.data_ptr(),
                     perm.data_ptr(), n_tiles, t, num_segments, *label, _stream(keys_tiled)),
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
    if not _on_cuda(ids_tiled, "tile_histograms"):
        return tile_histograms_plain(ids_tiled, num_buckets)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    hist = torch.empty((n_tiles, num_buckets), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("tile_histograms")
        _raise_on(fn(ids_tiled.data_ptr(), hist.data_ptr(), n_tiles, t,
                     *identity_args(num_buckets), _stream(ids_tiled)), "tile_histograms")
        tile_histograms.launches += 1
    return hist


def tile_positions_plain(ids_tiled: Tensor, g: Tensor, num_buckets: int) -> Tensor:
    return common.positions_body(clamp_ids(ids_tiled, num_buckets), g, num_buckets)


def tile_positions(ids_tiled: Tensor, g: Tensor, num_buckets: int) -> Tensor:
    """(L, T) int32 ids + (L, m) int32 bases -> (L, T) int32 destinations
    ``G[b] + rank``: K3 on the ids strip."""
    if not _on_cuda(ids_tiled, "tile_positions"):
        return tile_positions_plain(ids_tiled, g, num_buckets)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    _check_bases(g, ids_tiled, num_buckets)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("tile_positions")
        _raise_on(fn(ids_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(), n_tiles, t,
                     *identity_args(num_buckets), _stream(ids_tiled)), "tile_positions")
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
    if not _on_cuda(ids_tiled, "fused_postscan_reorder"):
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
        _raise_on(fn(ids_tiled.data_ptr(), g.data_ptr(), keys_tiled.data_ptr(), _ptr(values_tiled),
                     keys_r.data_ptr(), _ptr(vals_r), pos_r.data_ptr(), perm.data_ptr(), n_tiles,
                     t, num_buckets, _stream(ids_tiled)), "fused_postscan_reorder (ids)")
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
    if not _on_cuda(ids_tiled, "seg_tile_histograms"):
        return seg_tile_histograms_plain(ids_tiled, seg_tiled, num_buckets, num_segments)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    width = _check_segments(seg_tiled, ids_tiled, num_buckets, num_segments)
    hist = torch.empty((n_tiles, width), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_histograms")
        _raise_on(fn(ids_tiled.data_ptr(), seg_tiled.data_ptr(), hist.data_ptr(), n_tiles, t,
                     num_segments, *identity_args(num_buckets), _stream(ids_tiled)),
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
    if not _on_cuda(ids_tiled, "seg_tile_positions"):
        return seg_tile_positions_plain(ids_tiled, seg_tiled, g, num_buckets, num_segments)
    n_tiles, t = _check_ids(ids_tiled, num_buckets)
    width = _check_segments(seg_tiled, ids_tiled, num_buckets, num_segments)
    _check_bases(g, ids_tiled, width)
    pos = torch.empty((n_tiles, t), dtype=torch.int32, device=ids_tiled.device)
    if n_tiles:
        fn = build.load("seg_tile_positions")
        _raise_on(fn(ids_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(), pos.data_ptr(),
                     n_tiles, t, num_segments, *identity_args(num_buckets), _stream(ids_tiled)),
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
    if not _on_cuda(ids_tiled, "seg_fused_postscan_reorder"):
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
        _raise_on(fn(ids_tiled.data_ptr(), seg_tiled.data_ptr(), g.data_ptr(),
                     keys_tiled.data_ptr(), _ptr(values_tiled), keys_r.data_ptr(), _ptr(vals_r),
                     pos_r.data_ptr(), perm.data_ptr(), n_tiles, t, num_segments, num_buckets,
                     _stream(ids_tiled)), "seg_fused_postscan_reorder (ids)")
        seg_fused_postscan_reorder.launches += 1
    return keys_r, vals_r, pos_r, perm


# ---------------------------------------------------------------------------
# The labels of a declarative spec, written out
# ---------------------------------------------------------------------------

def spec_bucket_ids_plain(keys_tiled: Tensor, spec) -> Tensor:
    return clamp_ids(spec.emit(keys_tiled), spec.num_buckets)


def spec_bucket_ids(keys_tiled: Tensor, spec) -> Tensor:
    """(L, T) keys -> (L, T) int32 labels of a declarative spec, bitwise
    the labels K1-K3 compute in-register."""
    if not _on_cuda(keys_tiled, "spec_bucket_ids"):
        return spec_bucket_ids_plain(keys_tiled, spec)
    n_tiles, t = _check_keys(keys_tiled)
    label = label_args(spec, keys_tiled.dtype, keys_tiled.device)
    ids = torch.empty((n_tiles, t), dtype=torch.int32, device=keys_tiled.device)
    if n_tiles:
        fn = build.load("spec_bucket_ids")
        _raise_on(fn(keys_tiled.data_ptr(), ids.data_ptr(), n_tiles, t, *label,
                     _stream(keys_tiled)), "spec_bucket_ids")
        spec_bucket_ids.launches += 1
    return ids


KERNELS = (
    spec_tile_histograms, spec_fused_postscan_reorder, spec_tile_positions,
    seg_spec_tile_histograms, seg_spec_fused_postscan_reorder, seg_spec_tile_positions,
    tile_histograms, fused_postscan_reorder, tile_positions,
    seg_tile_histograms, seg_fused_postscan_reorder, seg_tile_positions,
    spec_bucket_ids,
)
reset_launches()
