"""The multisplit stage-graph pipeline, flat, batched and segmented layouts (counterpart of
``repro/core/pipeline``): {local prescan} → {one global scan} → {local
postscan} (paper §4.1).

* :mod:`~repro_torch.core.pipeline.stages`   — layout/scan primitives and
  the direct solve.
* :mod:`~repro_torch.core.pipeline.registry` — the backends {reference,
  vmap, cuda}.
* :mod:`~repro_torch.core.pipeline.tiles`    — tile and family resolution,
  the Hopper shared-memory model and the tile autotuner.
* :mod:`~repro_torch.core.pipeline.autotune` — autotune on a cache miss and
  its persistent cache.
* :mod:`~repro_torch.core.pipeline.spec`     — :class:`PipelineSpec` and
  the executable :class:`MultisplitPlan`.
* :mod:`~repro_torch.core.pipeline.radix`    — :class:`RadixPipeline`.
"""

from repro_torch.core.pipeline.autotune import (
    AutotuneConfig,
    autotune_fused2,
    autotune_label_fusion,
    autotune_status,
    set_autotune,
)
from repro_torch.core.pipeline.radix import (
    MAX_PAIR_BITS,
    RadixPipeline,
    radix_pass_pairs,
    radix_passes,
)
from repro_torch.core.pipeline.registry import (
    BACKENDS,
    Backend,
    KernelStages,
    StageImpl,
    VmapStages,
    available_backends,
    backend_names,
    get_backend,
    register_backend,
    resolve_backend,
)
from repro_torch.core.pipeline.spec import (
    MODES,
    MultisplitPlan,
    PipelineSpec,
    Stage,
    fusion_decision,
    fusion_decisions,
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
    direct_solve_reference,
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
    autotune_tile,
    clear_tile_cache,
    family_decision,
    family_decisions,
    pin_tile,
    resolve_kernel_family,
    resolve_sub_bits,
    resolve_tile,
    tile_decision,
)

__all__ = [
    "AutotuneConfig",
    "BACKENDS", "BMS_TILE", "Backend", "CUDA_TILE", "FAMILIES", "FUSED2_CUDA_TILE",
    "FUSED2_VMAP_TILE", "KernelStages", "MAX_PAIR_BITS", "MODES",
    "MultisplitPlan", "MultisplitResult", "PipelineSpec", "RadixPipeline",
    "Stage", "StageImpl", "VmapStages", "WMS_TILE",
    "autotune_fused2", "autotune_label_fusion", "autotune_status",
    "autotune_tile", "available_backends", "backend_names",
    "clear_tile_cache", "direct_counts", "direct_solve_ids",
    "direct_solve_reference", "exclusive_rows", "family_decision",
    "family_decisions", "fused2_tile_counts", "fused2_tile_postscan", "fusion_decision",
    "fusion_decisions", "get_backend", "global_scan",
    "make_batched_plan", "make_plan", "make_radix_plan",
    "make_segmented_plan", "make_segmented_radix_plan",
    "packed_direct_solve_ids", "packed_tile_local_offsets", "pad_rows",
    "pad_to_tiles", "pin_tile", "radix_pass_pairs", "radix_passes", "register_backend",
    "resolve_backend", "resolve_kernel_family", "resolve_sub_bits", "resolve_tile",
    "row_index", "seg_tile_local", "segment_ids_from_starts", "set_autotune",
    "tile_decision", "tile_local_offsets",
]
