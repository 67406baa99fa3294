"""Tile sizing and kernel-family resolution (counterpart of
``repro/core/pipeline/tiles.py`` without its VMEM models and autotuner).

The tile height is the paper's subproblem-size knob: larger tiles narrow
the global scan matrix H (L·m words) but deepen the local solve. It changes
cost only: every tile gives the same bits.

The port has one kernel family, ``onehot`` (on Hopper: the warp-ballot
rank); the packed family is ROADMAP queue B items 4-6. The family is a cost
axis only, so the main path needs no other.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.pipeline.registry import get_backend

FAMILIES = ("onehot",)

# The vmap backend keeps the JAX package's "warp" and "block" tiles.
WMS_TILE = 1024
BMS_TILE = 4096

# The cuda backend's tile, for every method and layout: 4096 keys give
# L = 8192 tiles (62 blocks an SM) at n = 2^25 and keep K2's shared memory
# (about 92 KB key-value at m = 256; K2s about 109 KB) within two blocks an
# SM. The segmented kernels keep m-wide state, so their shared memory does
# not grow with s and the tile stays the same at any m_eff = s·m. Not
# measured yet: ROADMAP queue A item 8 measures the tile on the H100.
CUDA_TILE = 4096
_MIN_TILE = 256

_TILE_CACHE: Dict[Tuple, int] = {}


def _heuristic_tile(n: int, m: int, method: str, backend: str) -> int:
    if get_backend(backend).uses_kernels:
        tile, floor = CUDA_TILE, _MIN_TILE
    else:
        tile, floor = (WMS_TILE if method in ("dms", "wms") else BMS_TILE), 128
    if n < tile:
        # a small input is one tile, padded to the next power of two
        tile = max(floor, 1 << max(n - 1, 0).bit_length())
    return tile


def resolve_kernel_family(
    n: int, m: int, method: str, backend: str, requested: Optional[str] = None
) -> str:
    """The kernel family of one shape: ``onehot``, the only one the port's
    backends implement. An explicit request is validated."""
    be = get_backend(backend)
    if requested is not None and requested not in be.families:
        raise ValueError(
            f"backend {backend!r} supports kernel families {be.families}, not "
            f"{requested!r} (the packed family is ROADMAP queue B items 4-6)"
        )
    return "onehot"


def resolve_tile(
    n: int, m: int, method: str, key_value: bool, backend: str,
    requested: Optional[int] = None,
) -> int:
    """Tile height for one shape, cached per shape; ``m`` is the scan width
    ``m_eff`` (``s·m`` for segmented plans). An explicit request is returned
    as it is and never cached."""
    if requested is not None:
        if requested < 1:
            raise ValueError(f"tile must be >= 1, got {requested}")
        return requested
    key = (n, m, method, key_value, backend)
    tile = _TILE_CACHE.get(key)
    if tile is None:
        tile = _heuristic_tile(n, m, method, backend)
        _TILE_CACHE[key] = tile
    return tile
