"""The multisplit stage-graph pipeline, flat, batched and segmented layouts (counterpart of
``repro/core/pipeline``): {local prescan} → {one global scan} → {local
postscan} (paper §4.1).

* :mod:`~repro_torch.core.pipeline.stages`   — layout/scan primitives and
  the direct solve.
* :mod:`~repro_torch.core.pipeline.registry` — the backends {reference,
  vmap, cuda}.
* :mod:`~repro_torch.core.pipeline.tiles`    — tile and family resolution.
* :mod:`~repro_torch.core.pipeline.spec`     — :class:`PipelineSpec` and
  the executable :class:`MultisplitPlan`.
* :mod:`~repro_torch.core.pipeline.radix`    — :class:`RadixPipeline`.
"""

from repro_torch.core.pipeline.radix import (
    MAX_PAIR_BITS,
    RadixPipeline,
    radix_pass_pairs,
    radix_passes,
)
from repro_torch.core.pipeline.registry import (
    Backend,
    KernelStages,
    StageImpl,
    VmapStages,
    backend_names,
    get_backend,
    register_backend,
)
from repro_torch.core.pipeline.spec import (
    MODES,
    MultisplitPlan,
    PipelineSpec,
    make_batched_plan,
    make_plan,
    make_radix_plan,
    make_segmented_plan,
    make_segmented_radix_plan,
)
from repro_torch.core.pipeline.stages import (
    MultisplitResult,
    direct_counts,
    direct_solve_ids,
    exclusive_rows,
    fused2_tile_counts,
    fused2_tile_postscan,
    global_scan,
    packed_direct_solve_ids,
    packed_tile_local_offsets,
    pad_rows,
    pad_to_tiles,
    row_index,
    seg_tile_local,
    segment_ids_from_starts,
    tile_local_offsets,
)
from repro_torch.core.pipeline.tiles import (
    BMS_TILE,
    CUDA_TILE,
    FAMILIES,
    FUSED2_CUDA_TILE,
    FUSED2_VMAP_TILE,
    WMS_TILE,
    family_decision,
    family_decisions,
    resolve_kernel_family,
    resolve_sub_bits,
    resolve_tile,
)

__all__ = [
    "BMS_TILE", "Backend", "CUDA_TILE", "FAMILIES", "FUSED2_CUDA_TILE", "FUSED2_VMAP_TILE",
    "KernelStages", "MAX_PAIR_BITS", "MODES",
    "MultisplitPlan", "MultisplitResult", "PipelineSpec", "RadixPipeline",
    "StageImpl", "VmapStages", "WMS_TILE", "backend_names",
    "direct_counts", "direct_solve_ids", "exclusive_rows", "family_decision",
    "family_decisions", "fused2_tile_counts", "fused2_tile_postscan", "get_backend",
    "global_scan", "make_batched_plan", "make_plan", "make_radix_plan",
    "make_segmented_plan", "make_segmented_radix_plan", "packed_direct_solve_ids",
    "packed_tile_local_offsets", "pad_rows", "pad_to_tiles", "radix_pass_pairs", "radix_passes",
    "register_backend", "resolve_kernel_family", "resolve_sub_bits", "resolve_tile",
    "row_index", "seg_tile_local", "segment_ids_from_starts", "tile_local_offsets",
]
