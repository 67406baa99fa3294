"""The kernel doors the pipeline calls (counterpart of
``repro/kernels/ops.py:72-92, 95-107, 129-340, 346-450``).

Each door takes tiled tensors and a declarative spec, or a materialised
int32 ids strip and the number of buckets, and dispatches on the tensors'
device through the wrappers of :mod:`repro_torch.kernels.multisplit_tile`:
the CUDA kernel for a CUDA tensor, the plain version for a CPU one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.identifiers import EvenSpec
from repro_torch.kernels import multisplit_tile as _mst
from repro_torch.kernels import radix_pass as _radix

Tensor = torch.Tensor


# -- materialised labels: the int32 ids strip --------------------------------

def tile_histograms(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    return _mst.tile_histograms(ids_tiled, num_buckets)


def tile_positions(ids_tiled: Tensor, g: Tensor, num_buckets: int) -> Tensor:
    return _mst.tile_positions(ids_tiled, g, num_buckets)


def fused_postscan_reorder(
    ids_tiled: Tensor, g: Tensor, keys_tiled: Tensor, values_tiled: Optional[Tensor],
    num_buckets: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return _mst.fused_postscan_reorder(ids_tiled, g, keys_tiled, values_tiled, num_buckets)


def seg_tile_histograms(
    ids_tiled: Tensor, seg_tiled: Tensor, num_buckets: int, num_segments: int
) -> Tensor:
    return _mst.seg_tile_histograms(ids_tiled, seg_tiled, num_buckets, num_segments)


def seg_tile_positions(
    ids_tiled: Tensor, seg_tiled: Tensor, g: Tensor, num_buckets: int, num_segments: int
) -> Tensor:
    return _mst.seg_tile_positions(ids_tiled, seg_tiled, g, num_buckets, num_segments)


def seg_fused_postscan_reorder(
    ids_tiled: Tensor, seg_tiled: Tensor, g: Tensor, keys_tiled: Tensor,
    values_tiled: Optional[Tensor], num_buckets: int, num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return _mst.seg_fused_postscan_reorder(
        ids_tiled, seg_tiled, g, keys_tiled, values_tiled, num_buckets, num_segments
    )


def tile_reorder(
    ids_tiled: Tensor, keys_tiled: Tensor, values_tiled: Tensor, num_buckets: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Stable bucket-major reorder of (keys, values) within each tile and
    the in-tile destination map (B10); the JAX door's signature, values
    required."""
    return _mst.tile_reorder(ids_tiled, keys_tiled, values_tiled, num_buckets)


def device_histogram(ids_tiled: Tensor, num_buckets: int) -> Tensor:
    """(L, T) ids -> (m,) int32 device-wide histogram: the tile histograms
    summed over the tiles."""
    return _mst.tile_histograms(ids_tiled, num_buckets).sum(0, dtype=torch.int32)


def spec_bucket_ids(keys_tiled: Tensor, spec) -> Tensor:
    """(L, T) keys -> (L, T) int32 labels of any declarative spec."""
    return _mst.spec_bucket_ids(keys_tiled, spec)


def even_bucket_ids(keys_tiled: Tensor, lo: float, hi: float, num_buckets: int) -> Tensor:
    """Even-width labels through the spec-ids kernel."""
    return _mst.spec_bucket_ids(keys_tiled, EvenSpec(float(lo), float(hi), num_buckets))


# -- labels in the kernel: a declarative spec --------------------------------


def spec_tile_histograms(keys_tiled: Tensor, spec) -> Tensor:
    return _mst.spec_tile_histograms(keys_tiled, spec)


def spec_tile_positions(keys_tiled: Tensor, g: Tensor, spec) -> Tensor:
    return _mst.spec_tile_positions(keys_tiled, g, spec)


def spec_fused_postscan_reorder(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], spec
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return _mst.spec_fused_postscan_reorder(keys_tiled, g, values_tiled, spec)


def seg_spec_tile_histograms(keys_tiled: Tensor, seg_tiled: Tensor, spec, num_segments: int) -> Tensor:
    return _mst.seg_spec_tile_histograms(keys_tiled, seg_tiled, spec, num_segments)


def seg_spec_tile_positions(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, spec, num_segments: int
) -> Tensor:
    return _mst.seg_spec_tile_positions(keys_tiled, seg_tiled, g, spec, num_segments)


def seg_spec_fused_postscan_reorder(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], spec,
    num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return _mst.seg_spec_fused_postscan_reorder(
        keys_tiled, seg_tiled, g, values_tiled, spec, num_segments
    )


# -- the packed family: one door a stage for {ids | spec} × {flat | segmented}


def packed_tile_histograms(
    tiled: Tensor, seg_tiled: Optional[Tensor] = None, *, num_buckets: Optional[int] = None,
    spec=None, num_segments: int = 1, bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tensor:
    return _mst.packed_tile_histograms(
        tiled, seg_tiled, num_buckets=num_buckets, spec=spec, num_segments=num_segments,
        bits=bits, subtile=subtile)


def packed_tile_positions(
    tiled: Tensor, g: Tensor, seg_tiled: Optional[Tensor] = None, *,
    num_buckets: Optional[int] = None, spec=None, num_segments: int = 1,
    bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tensor:
    return _mst.packed_tile_positions(
        tiled, g, seg_tiled, num_buckets=num_buckets, spec=spec, num_segments=num_segments,
        bits=bits, subtile=subtile)


def packed_fused_postscan_reorder(
    tiled: Tensor, g: Tensor, keys_tiled: Optional[Tensor] = None,
    values_tiled: Optional[Tensor] = None, seg_tiled: Optional[Tensor] = None, *,
    num_buckets: Optional[int] = None, spec=None, num_segments: int = 1,
    bits: Optional[int] = None, subtile: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return _mst.packed_fused_postscan_reorder(
        tiled, g, keys_tiled, values_tiled, seg_tiled, num_buckets=num_buckets, spec=spec,
        num_segments=num_segments, bits=bits, subtile=subtile)


# -- the fused two-digit family: one door a stage for {flat | segmented};
# ``spec`` is the pair's BitfieldSpec and ``split`` the low digit's width


def fused2_tile_histograms(
    keys_tiled: Tensor, seg_tiled: Optional[Tensor] = None, *, spec, num_segments: int = 1,
) -> Tensor:
    return _mst.fused2_tile_histograms(keys_tiled, seg_tiled, spec=spec,
                                       num_segments=num_segments)


def fused2_tile_positions(
    keys_tiled: Tensor, g: Tensor, seg_tiled: Optional[Tensor] = None, *, spec, split: int,
    num_segments: int = 1, family: str = "onehot", sub_bits: Optional[int] = None,
) -> Tensor:
    return _mst.fused2_tile_positions(
        keys_tiled, g, seg_tiled, spec=spec, split=split, num_segments=num_segments,
        family=family, sub_bits=sub_bits)


def fused2_fused_postscan_reorder(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor] = None,
    seg_tiled: Optional[Tensor] = None, *, spec, split: int, num_segments: int = 1,
    family: str = "onehot", sub_bits: Optional[int] = None,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return _mst.fused2_fused_postscan_reorder(
        keys_tiled, g, values_tiled, seg_tiled, spec=spec, split=split,
        num_segments=num_segments, family=family, sub_bits=sub_bits)


def seg_radix_tile_histograms(
    keys_tiled: Tensor, seg_tiled: Tensor, shift: int, bits: int, num_segments: int
) -> Tensor:
    return _radix.seg_radix_tile_histograms(keys_tiled, seg_tiled, shift, bits, num_segments)


def seg_radix_tile_positions(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, shift: int, bits: int, num_segments: int
) -> Tensor:
    return _radix.seg_radix_tile_positions(keys_tiled, seg_tiled, g, shift, bits, num_segments)


def seg_radix_fused_postscan_reorder(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor],
    shift: int, bits: int, num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    return _radix.seg_radix_fused_postscan_reorder(
        keys_tiled, seg_tiled, g, values_tiled, shift, bits, num_segments
    )
