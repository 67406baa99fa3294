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

Fused two-digit plans (``digits=2``, a ``digit_split``) key both caches
with a digits slot, as the JAX package does (``tiles.py:59-87``): their
family is decided at the stage width ``stage_m`` and must never collide
with a ``digits=1`` plan of ``m == stage_m``, and their tile at the pair's
width with ``stage_m`` beside it. Their tile is its own constant
(:data:`FUSED2_CUDA_TILE`, :data:`FUSED2_VMAP_TILE`): a pair's histograms
and bases H are L·s·m² words, so the pair wants few tiles.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.pipeline.registry import get_backend

FAMILIES = ("onehot", "packed")

# The vmap backend keeps the JAX package's "warp" and "block" tiles.
WMS_TILE = 1024
BMS_TILE = 4096

# The cuda backend's tile, for every method and layout: 4096 keys give
# L = 8192 tiles (62 an SM) at n = 2^25. K1 and K2 run persistent blocks
# that walk the tiles: K2 stages two tiles of keys and values (79 KiB a
# block key-value at m = 256, 111 KiB with the ids plane), two blocks an
# SM; K2s keeps about 109 KB a block, one tile, within two blocks an SM.
# The segmented kernels keep m-wide state, so their shared memory does not
# grow with s and the tile stays the same at any m_eff = s·m. Not
# measured yet: ROADMAP queue A item 8 measures the tile on the H100.
CUDA_TILE = 4096
_MIN_TILE = 256
# The cuda backend's fused-pair tile: the largest the kernels take. A pair's
# H is L·s·m² int32 words (1 GiB at n = 2^25, r = 8 in tiles of 8192; 2 GiB
# in tiles of 4096) and the global scan reads and writes it several times,
# so the tile is as large as the sweep's shared memory allows: 16 bytes a
# key (two key buffers, two 16-bit index buffers, the rank's meta words)
# and 4 more for the segment runs, 160 KB at 8192 keys with 12 KB of
# counters, one block an SM. Measured on the H100: the fused r = 8
# key-value sort of 2^25 keys takes 27.5 ms in tiles of 8192 and 39.1 ms in
# tiles of 4096 (PERF.md §6, the fused-radix findings).
FUSED2_CUDA_TILE = 8192
# The vmap backend's: the plain bodies have no shared-memory limit, and the
# JAX gather-form heuristic grows the pair's tile toward n for the same
# reason (``tiles.py:146-157``); the port caps it at 2^16 keys.
FUSED2_VMAP_TILE = 1 << 16

# digits=1: (n, m_eff, method, key_value, backend); digits=2 appends
# (2, stage_m)
_TILE_CACHE: Dict[Tuple, int] = {}
# digits=1: (n, m_eff, method, backend); digits=2 appends the digits slot
# and m is the stage width. Values are (family, reason).
_FAMILY_CACHE: Dict[Tuple, Tuple[str, str]] = {}


def _family_key(n: int, m: int, method: str, backend: str, digits: int) -> Tuple:
    base = (n, m, method, backend)
    return base if digits == 1 else base + (digits,)


def _tile_key(n: int, m: int, method: str, key_value: bool, backend: str, digits: int,
              stage_m: Optional[int]) -> Tuple:
    base = (n, m, method, key_value, backend)
    return base if digits == 1 else base + (digits, stage_m)


def _heuristic_tile(n: int, m: int, method: str, backend: str, digits: int = 1) -> int:
    kernels = get_backend(backend).uses_kernels
    if digits == 2:
        tile, floor = (FUSED2_CUDA_TILE, _MIN_TILE) if kernels else (FUSED2_VMAP_TILE, 128)
    elif kernels:
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
    n: int, m: int, method: str, backend: str, requested: Optional[str] = None,
    digits: int = 1,
) -> str:
    """The kernel family of one shape (``m`` is ``m_eff``, or the stage
    width of a fused pair with ``digits=2``), cached per shape with the
    reason it was chosen (:func:`family_decision`). An explicit
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
    key = _family_key(n, m, method, backend, digits)
    hit = _FAMILY_CACHE.get(key)
    if hit is None:
        hit = _heuristic_family(n, m, method, backend)
        _FAMILY_CACHE[key] = hit
    return hit[0]


def family_decision(
    n: int, m: int, method: str, backend: str, digits: int = 1
) -> Tuple[str, str]:
    """(family, reason) of one shape, resolved (and cached) first if need
    be."""
    resolve_kernel_family(n, m, method, backend, digits=digits)
    return _FAMILY_CACHE[_family_key(n, m, method, backend, digits)]


def family_decisions() -> Dict[Tuple, Tuple[str, str]]:
    """A snapshot of every (shape -> (family, reason)) decision so far."""
    return dict(_FAMILY_CACHE)


def resolve_tile(
    n: int, m: int, method: str, key_value: bool, backend: str,
    requested: Optional[int] = None, digits: int = 1, stage_m: Optional[int] = None,
) -> int:
    """Tile height for one shape, cached per shape; ``m`` is the scan width
    ``m_eff`` (``s·m`` for segmented plans, ``s·m²`` for a fused pair with
    ``digits=2`` and its stage width ``stage_m``). An explicit request is
    returned as it is and never cached."""
    if requested is not None:
        if requested < 1:
            raise ValueError(f"tile must be >= 1, got {requested}")
        return requested
    key = _tile_key(n, m, method, key_value, backend, digits, stage_m)
    tile = _TILE_CACHE.get(key)
    if tile is None:
        tile = _heuristic_tile(n, m, method, backend, digits)
        _TILE_CACHE[key] = tile
    return tile


def resolve_sub_bits(requested: Optional[int] = None) -> Optional[int]:
    """The in-tile sub-digit stage width of a fused-pair plan: the request,
    else None, which leaves the width to the stage bodies (the cuda
    kernels' measured :data:`~repro_torch.kernels.multisplit_tile.
    CUDA_SUB_BITS`, the plain bodies' :data:`~repro_torch.kernels.common.
    FUSED2_SUB_BITS`). The JAX package's autotuner, which measures a width
    for each shape (``tiles.py:308-331``), is ROADMAP queue A item 8. Every
    width gives the same bits."""
    return requested
