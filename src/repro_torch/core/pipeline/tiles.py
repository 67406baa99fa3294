"""Tile sizing and kernel-family resolution (counterpart of
``repro/core/pipeline/tiles.py`` without its VMEM models and autotuner).

The tile height is the paper's subproblem-size knob: larger tiles narrow
the global scan matrix H (L·m words) but deepen the local solve. It changes
cost only: every tile gives the same bits.

The kernel family is the local solve's second cost axis; both give the
same bits:

* ``onehot`` — on Hopper the warp-ballot rank with int32 counters (K1-K3);
* ``packed`` — 8-bit subword counters, four to a word, with a two-level
  (subtile -> tile) rank (paper §4.3; K1p-K3p).

Every family decision is cached with the reason it was made
(:func:`family_decision`); an explicit request is validated and never
cached. The default is ``onehot`` on every backend: the JAX package's
crossover (packed from ``m_eff >= 8``, ``repro/core/pipeline/tiles.py:47-57``)
was measured on a CPU host, and no constant of the TPU or CPU era is the
port's default. ROADMAP queue A item 8 sets the cuda backend's default
from the H100 measurements of both families.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.pipeline.registry import get_backend

FAMILIES = ("onehot", "packed")

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
# (n, m_eff, method, backend) -> (family, reason)
_FAMILY_CACHE: Dict[Tuple[int, int, str, str], Tuple[str, str]] = {}


def _heuristic_tile(n: int, m: int, method: str, backend: str) -> int:
    if get_backend(backend).uses_kernels:
        tile, floor = CUDA_TILE, _MIN_TILE
    else:
        tile, floor = (WMS_TILE if method in ("dms", "wms") else BMS_TILE), 128
    if n < tile:
        # a small input is one tile, padded to the next power of two
        tile = max(floor, 1 << max(n - 1, 0).bit_length())
    return tile


def _heuristic_family(n: int, m: int, method: str, backend: str) -> Tuple[str, str]:
    be = get_backend(backend)
    if not be.tiled:
        return "onehot", "untiled direct-solve backend: no tile local solve"
    if "packed" not in be.families:
        return "onehot", f"backend {backend!r} advertises no packed support"
    return "onehot", (
        f"m_eff={m}: the port keeps onehot by default; the JAX crossover (packed from "
        f"m_eff >= 8) was measured on a CPU host, not on Hopper, and ROADMAP A8 sets "
        f"the cuda default from the H100 measurements of both families"
    )


def resolve_kernel_family(
    n: int, m: int, method: str, backend: str, requested: Optional[str] = None
) -> str:
    """The kernel family of one shape (``m`` is ``m_eff``), cached per shape
    with the reason it was chosen (:func:`family_decision`). An explicit
    ``requested`` family is validated against :data:`FAMILIES` and the
    backend's ``families`` and returned as it is, never cached: a one-off
    override does not change what later plans of the shape resolve to."""
    be = get_backend(backend)
    if requested is not None:
        if requested not in FAMILIES:
            raise ValueError(
                f"unknown kernel family {requested!r}; expected one of {FAMILIES}"
            )
        if be.tiled and requested not in be.families:
            raise ValueError(
                f"backend {backend!r} supports kernel families {be.families}, "
                f"not {requested!r}"
            )
        return requested
    key = (n, m, method, backend)
    hit = _FAMILY_CACHE.get(key)
    if hit is None:
        hit = _heuristic_family(n, m, method, backend)
        _FAMILY_CACHE[key] = hit
    return hit[0]


def family_decision(n: int, m: int, method: str, backend: str) -> Tuple[str, str]:
    """(family, reason) of one shape, resolved (and cached) first if need
    be."""
    resolve_kernel_family(n, m, method, backend)
    return _FAMILY_CACHE[(n, m, method, backend)]


def family_decisions() -> Dict[Tuple[int, int, str, str], Tuple[str, str]]:
    """A snapshot of every (shape -> (family, reason)) decision so far."""
    return dict(_FAMILY_CACHE)


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
