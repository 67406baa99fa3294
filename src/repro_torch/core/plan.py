"""Compatibility shim: the plan layer lives in :mod:`repro_torch.core.pipeline`
(counterpart of ``repro/core/plan.py``).

``from repro_torch.core.plan import make_plan`` and the other names below
import the very objects of the pipeline package (the tile cache here IS the
package's cache, not a copy), as the JAX package's shim re-exports its
pipeline. Only the symbols the port has are re-exported: the JAX shim's
backend aliases (``BACKENDS``, ``available_backends``, ``resolve_backend``),
its ``Stage`` record, its VMEM budget and its autotuner
(``autotune_tile``, ``clear_tile_cache``; ROADMAP queue A item 8) have no
counterpart yet. New code imports :mod:`repro_torch.core.pipeline`.
"""

from __future__ import annotations

from repro_torch.core.pipeline.radix import RadixPipeline, radix_passes
from repro_torch.core.pipeline.registry import (
    Backend,
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
    exclusive_rows,
    global_scan,
    pad_rows,
    pad_to_tiles,
    segment_ids_from_starts,
    tile_local_offsets,
)
from repro_torch.core.pipeline.stages import direct_solve_ids as _direct_solve_ids
from repro_torch.core.pipeline.stages import exclusive_rows as _exclusive_rows
from repro_torch.core.pipeline.stages import seg_tile_local as _seg_tile_local
from repro_torch.core.pipeline.stages import tile_local_offsets as _tile_local_offsets
from repro_torch.core.pipeline.tiles import (
    _FAMILY_CACHE,
    _MIN_TILE,
    _TILE_CACHE,
    BMS_TILE,
    FAMILIES,
    WMS_TILE,
    _heuristic_tile,
    family_decision,
    family_decisions,
    resolve_kernel_family,
    resolve_tile,
)

__all__ = [
    "BMS_TILE", "Backend", "FAMILIES", "MODES", "MultisplitPlan",
    "MultisplitResult", "PipelineSpec", "RadixPipeline", "WMS_TILE",
    "backend_names", "direct_counts", "exclusive_rows", "family_decision",
    "family_decisions", "get_backend", "global_scan", "make_batched_plan",
    "make_plan", "make_radix_plan", "make_segmented_plan",
    "make_segmented_radix_plan", "pad_rows", "pad_to_tiles", "radix_passes",
    "register_backend", "resolve_kernel_family", "resolve_tile",
    "segment_ids_from_starts", "tile_local_offsets",
]
