"""The kernel doors the pipeline calls (counterpart of
``repro/kernels/ops.py:129-190`` and, for the segmented radix pass,
``:384-419``).

Each door takes tiled tensors and a declarative spec and dispatches on the
tensors' device through the wrappers of
:mod:`repro_torch.kernels.multisplit_tile`: the CUDA kernel for a CUDA
tensor, the plain version for a CPU one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import multisplit_tile as _mst
from repro_torch.kernels import radix_pass as _radix

Tensor = torch.Tensor


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
