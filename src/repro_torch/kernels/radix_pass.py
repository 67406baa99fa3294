"""Radix-pass doors: thin :class:`BitfieldSpec` instances of the tile kernels.

Counterpart of ``repro/kernels/radix_pass.py:37-110``. One LSD radix pass
(paper §7.1) is a multisplit by the digit ``(u >> shift) & (2^bits - 1)``;
the digit is computed inside K1-K3 (and, with a segment strip, K1s-K3s)
like every other spec's label, so no digit array exists in device memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.identifiers import BitfieldSpec
from repro_torch.kernels import multisplit_tile as _mst

Tensor = torch.Tensor


def radix_tile_histograms(keys_tiled: Tensor, shift: int, bits: int) -> Tensor:
    """(L, T) integer keys -> (L, 2^bits) per-tile digit histograms (K1)."""
    return _mst.spec_tile_histograms(keys_tiled, BitfieldSpec(shift, bits))


def radix_tile_positions(keys_tiled: Tensor, g: Tensor, shift: int, bits: int) -> Tensor:
    """DMS postscan of one radix pass: (L, T) destinations (K3)."""
    return _mst.spec_tile_positions(keys_tiled, g, BitfieldSpec(shift, bits))


def radix_fused_postscan_reorder(
    keys_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor], shift: int, bits: int
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """Fused postscan of one radix pass, digit-major within each tile (K2)."""
    return _mst.spec_fused_postscan_reorder(
        keys_tiled, g, values_tiled, BitfieldSpec(shift, bits)
    )


def seg_radix_tile_histograms(
    keys_tiled: Tensor, seg_tiled: Tensor, shift: int, bits: int, num_segments: int
) -> Tensor:
    """(L, T) keys + (L, T) segment ids -> (L, s·2^bits) combined digit
    histograms (K1s)."""
    return _mst.seg_spec_tile_histograms(
        keys_tiled, seg_tiled, BitfieldSpec(shift, bits), num_segments
    )


def seg_radix_tile_positions(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, shift: int, bits: int, num_segments: int
) -> Tensor:
    """Segmented DMS postscan of one radix pass: (seg, digit) destinations
    (K3s)."""
    return _mst.seg_spec_tile_positions(
        keys_tiled, seg_tiled, g, BitfieldSpec(shift, bits), num_segments
    )


def seg_radix_fused_postscan_reorder(
    keys_tiled: Tensor, seg_tiled: Tensor, g: Tensor, values_tiled: Optional[Tensor],
    shift: int, bits: int, num_segments: int,
) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
    """Segmented fused postscan of one radix pass, (seg, digit)-major within
    each tile (K2s)."""
    return _mst.seg_spec_fused_postscan_reorder(
        keys_tiled, seg_tiled, g, values_tiled, BitfieldSpec(shift, bits), num_segments
    )
