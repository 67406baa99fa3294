"""Tile sizing, kernel-family resolution and the tile autotuner (counterpart
of ``repro/core/pipeline/tiles.py``), with a Hopper shared-memory and
occupancy model in place of the JAX package's VMEM working-set models.

The tile height is the paper's subproblem-size knob: larger tiles narrow
the global scan matrix H (L·m words) but deepen the local solve. It changes
cost only: every tile gives the same bits.

The kernel family is the local solve's second cost axis; both give the
same bits:

* ``onehot`` — on Hopper the warp-ballot rank with int32 counters (K1-K3);
* ``packed`` — 8-bit subword counters, four to a word, with a two-level
  (subtile -> tile) rank (paper §4.3; K1p-K3p).

Every family decision is cached with the reason it was made
(:func:`family_decision`), and every tile decision too
(:func:`tile_decision`, whose reason names the blocks an SM of the plan's
kernels); an explicit request is validated and never cached. Each default
is pinned from the H100 (NVIDIA H100 80GB HBM3 at 700 W, ``PERF.md``
§6-§7): ``onehot`` (every packed kernel is slower than its onehot twin),
:data:`CUDA_TILE`, :data:`FUSED2_CUDA_TILE` and the kernels' stage width
(``kernels/multisplit_tile.py`` ``CUDA_SUB_BITS``). The radix sort's
``fuse_digits`` stays off by default for the same reason: the fused r = 8
key-value sort of 2^25 keys takes 20.13-20.15 ms against the unfused
sort's 5.03-5.20 ms in one call (4.0x; PERF.md §6), the scan over the pair's H
taking most of it.

Fused two-digit plans (``digits=2``, a ``digit_split``) key both caches
with a digits slot, as the JAX package does (``tiles.py:59-87``): their
family is decided at the stage width ``stage_m`` and must never collide
with a ``digits=1`` plan of ``m == stage_m``, and their tile at the pair's
width with ``stage_m`` beside it.

Autotuning (:mod:`~repro_torch.core.pipeline.autotune`) is opt-in
(``ops.set_autotune(True)`` / ``REPRO_AUTOTUNE=1``): a cache miss then
consults the persistent cache and otherwise times the candidates. A family
miss runs the joint (tile x family) search, a tile miss searches tiles under
the family already resolved, so a plan never mixes a heuristic family with
a tile tuned for another. :func:`clear_tile_cache` also reaches what the
layers above registered with :func:`on_clear`: the plans ``ops`` cached
and the resilience layer's quarantine sidecar (``runtime/resilience.py``),
whose loaded snapshot it drops and whose file ``disk=True`` deletes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.identifiers import BitfieldSpec, BucketSpec
from repro_torch.core.pipeline.registry import get_backend
from repro_torch.kernels.build import CSRC

FAMILIES = ("onehot", "packed")

# The vmap backend keeps the JAX package's "warp" and "block" tiles.
WMS_TILE = 1024
BMS_TILE = 4096

# The cuda backend's tile, for every method and layout: 4096 keys give
# L = 8192 tiles (62 an SM) at n = 2^25, K1 four blocks an SM and K2 two
# (two staged tiles, 79 KiB a block key-value at m = 256). Measured on the
# H100 by autotune_tile over {2048, 4096, 8192}, onehot, key-value bms, the
# least of 7 calls, two searches a cell, on uniform 32-bit keys that fill
# every bucket (chip_smoke.py's autotune phase; NVIDIA H100 80GB HBM3,
# 700 W): the flat call at 2^25, m = 256, 1.5876 / 1.3740 / 1.8362 and
# 1.5325 / 1.3309 / 1.8468 ms (4096 wins both); S1 (64 segments, m = 32)
# 2.5935 / 2.0300 / 2.0032 and 2.5888 / 2.0625 / 2.0130 ms (8192 wins both,
# by 1.3 and 2.4 %). 4096 wins one cell and is within 3 % in the other, so
# it stays: another tile would have to win both.
CUDA_TILE = 4096
_MIN_TILE = 256
MAX_TILE = 8192           # the kernels' largest tile (kernels/multisplit_tile.py)
# The cuda backend's fused-pair tile: the largest the kernels take. A pair's
# H is L·s·m² int32 words (1 GiB at n = 2^25, r = 8 in tiles of 8192; 2 GiB
# in tiles of 4096) and the global scan reads and writes it several times,
# so the tile is as large as the sweep's shared memory allows. Measured on
# the H100 (NVIDIA H100 80GB HBM3, 700 W): the fused r = 8 key-value
# sort of 2^25 keys takes 27.5 ms in tiles of 8192 and 39.1 ms in tiles of
# 4096 (PERF.md §6, the fused-radix findings). The fused-pair grid of
# chip_smoke.py (autotune_fused2 at 2^22, the pair (0, 16, 8), key-value;
# NVIDIA H100 80GB HBM3, 700 W) pinned (8192, onehot, 8): 1.4093 ms against 2.3178 in tiles
# of 4096, stages of 4 bits 1.4311.
FUSED2_CUDA_TILE = 8192
# The vmap backend's: the plain bodies have no shared-memory limit, and the
# JAX gather-form heuristic grows the pair's tile toward n for the same
# reason (``tiles.py:146-157``); the port caps it at 2^16 keys.
FUSED2_VMAP_TILE = 1 << 16

# digits=1: (n, m_eff, method, key_value, backend); digits=2 appends
# (2, stage_m)
_TILE_CACHE: Dict[Tuple, int] = {}
# the reasons of the tiles the autotuner, the disk cache or pin_tile set,
# under _TILE_CACHE's keys (a heuristic tile's reason is derived on demand)
_TILE_REASONS: Dict[Tuple, str] = {}
# digits=1: (n, m_eff, method, backend); digits=2 appends the digits slot
# and m is the stage width. Values are (family, reason).
_FAMILY_CACHE: Dict[Tuple, Tuple[str, str]] = {}
# (n, m_eff, method, key_value, backend, stage_m) -> the fused pair's stage
# width. Only the autotuner writes here; on a miss the stage bodies' own
# width applies.
_SUB_BITS_CACHE: Dict[Tuple, int] = {}


def _family_key(n: int, m: int, method: str, backend: str, digits: int) -> Tuple:
    base = (n, m, method, backend)
    return base if digits == 1 else base + (digits,)


def _tile_key(n: int, m: int, method: str, key_value: bool, backend: str, digits: int,
              stage_m: Optional[int]) -> Tuple:
    base = (n, m, method, key_value, backend)
    return base if digits == 1 else base + (digits, stage_m)


# ---------------------------------------------------------------------------
# The Hopper shared-memory and occupancy model
# ---------------------------------------------------------------------------

# The H100 SXM's per-SM and per-block limits (CUDA's device attributes on an
# H100 80GB HBM3), used where no card is present; on a card the model reads
# torch.cuda.get_device_properties.
H100_LIMITS = {
    "sms": 132,
    "smem_per_sm": 233472,            # 228 KiB
    "smem_per_block_optin": 232448,   # 227 KiB
    "threads_per_sm": 2048,
    "regs_per_sm": 65536,
    "blocks_per_sm": 32,
}
_RESERVED_SMEM = 1024     # shared bytes the runtime keeps a block (sm_90)
_SMEM_GRANULE = 128       # shared memory is allocated in 128-byte units
_REG_GRANULE = 256        # registers are allocated a warp at a time, 256 at once
_SUBPARTITIONS = 4        # an SM's register file is four sub-partitions


def _source_constant(source: str, name: str) -> int:
    """The integer ``constexpr int name = N;`` of the kernel source
    ``csrc/source``: the model sizes shared memory with the launchers' own
    numbers, read where they are defined."""
    found = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    if found is None:
        raise LookupError(f"csrc/{source} defines no integer constant {name}")
    return int(found.group(1))


_WARPS = _source_constant("multisplit_common.cuh", "kWarps")
_MAX_BUCKETS = _source_constant("multisplit_common.cuh", "kMaxBuckets")
_K1_COPY_WORDS = _source_constant("tile_histograms.cu", "kCopyWords")
_K1S_SET_WORDS = _source_constant("seg_tile_histograms.cu", "kSetWords")
_K1P_SET_WORDS = _source_constant("packed_tile_histograms.cu", "kSetWords")
_K1F_BLOCK = _source_constant("fused2_tile_histograms.cu", "kBlock")
# fused2_tile_histograms.cu kWindowCells, 16-bit counters over the widest pair
_K1F_WINDOW_CELLS = 1 << _source_constant("multisplit_fused2.cuh", "kMaxPairBits")
_FUSED2_MAX_ROUNDS = MAX_TILE // 32
_SEG_STATIC = 4 * (MAX_TILE // 32) + 8 * (MAX_TILE // 33 + 1) + 4   # flags, long runs, their count


@dataclasses.dataclass(frozen=True)
class KernelLayout:
    """What one kernel of a plan asks of an SM at a given tile: its kernel
    wrapper's name, threads a block, the minimum blocks an SM of its
    ``__launch_bounds__`` (which caps its registers), its dynamic shared
    bytes with one stage (``two``: with two, where the launcher chooses)
    and an estimate of its static shared bytes from the source's
    ``__shared__`` arrays (the card reports the compiler's own)."""

    kernel: str
    threads: int
    min_blocks: int
    one: int
    two: Optional[int]
    static: int


@dataclasses.dataclass(frozen=True)
class Occupancy:
    """The launcher's choice for one kernel: stages, dynamic shared bytes,
    and the blocks an SM the card then allows (0: it cannot launch)."""

    stages: int
    smem: int
    blocks: int


def device_limits(device=None) -> Dict[str, int]:
    """The card's limits for the model: ``torch.cuda.get_device_properties``
    where a card is present (``device`` a CUDA device, or None), else
    :data:`H100_LIMITS`."""
    dev = torch.device(device) if device is not None else None
    if not torch.cuda.is_available() or (dev is not None and dev.type != "cuda"):
        return dict(H100_LIMITS)
    props = torch.cuda.get_device_properties(dev if dev is not None else torch.cuda.current_device())
    read = {"sms": "multi_processor_count", "smem_per_sm": "shared_memory_per_multiprocessor",
            "smem_per_block_optin": "shared_memory_per_block_optin",
            "threads_per_sm": "max_threads_per_multi_processor",
            "regs_per_sm": "regs_per_multiprocessor"}
    out = dict(H100_LIMITS)
    out.update({key: int(getattr(props, name)) for key, name in read.items()
                if getattr(props, name, None)})
    return out


def _round_up(x: int, unit: int) -> int:
    return -(-x // unit) * unit


def register_ceiling(threads: int, min_blocks: int) -> int:
    """The registers a thread ptxas may use under ``__launch_bounds__(threads,
    min_blocks)``: what still lets ``min_blocks`` blocks share an SM."""
    return min(255, (H100_LIMITS["regs_per_sm"] // (min_blocks * threads)) & ~7)


def blocks_per_sm(threads: int, smem: int, static: int, registers: int,
                  limits: Optional[Dict[str, int]] = None) -> int:
    """The blocks an SM the card allows a kernel of ``threads`` threads,
    ``registers`` registers a thread and ``static`` + ``smem`` shared bytes:
    the least of the thread, register and shared-memory limits, as CUDA's
    occupancy calculator counts them (registers allocated 256 a warp in four
    sub-partitions; shared memory in 128-byte units with 1 KiB a block
    reserved). 0 when a block cannot launch at all."""
    lim = limits or H100_LIMITS
    warps = -(-threads // 32)
    by_threads = min(lim["blocks_per_sm"], lim["threads_per_sm"] // (32 * warps))
    per_warp = _round_up(registers * 32, _REG_GRANULE)
    by_regs = ((lim["regs_per_sm"] // _SUBPARTITIONS) // per_warp) * _SUBPARTITIONS // warps
    if smem + static > lim["smem_per_block_optin"]:
        return 0
    by_smem = lim["smem_per_sm"] // _round_up(smem + static + _RESERVED_SMEM, _SMEM_GRANULE)
    return max(0, min(by_threads, by_regs, by_smem))


def occupancy(layout: KernelLayout, registers: Optional[int] = None,
              static: Optional[int] = None,
              limits: Optional[Dict[str, int]] = None) -> Occupancy:
    """The launcher's (stages, shared bytes, blocks an SM) for ``layout``,
    with ``sm90::pick_stages``'s rule: two stages where they fit the
    per-block limit and cost no block an SM. ``registers`` and ``static``
    are the compiler's (the card reports both); without them the model takes
    the register ceiling of the kernel's ``__launch_bounds__`` and the
    static estimate."""
    lim = limits or H100_LIMITS
    regs = registers if registers is not None else register_ceiling(layout.threads,
                                                                     layout.min_blocks)
    st = layout.static if static is None else static
    one = blocks_per_sm(layout.threads, layout.one, st, regs, lim)
    if layout.two is None:
        return Occupancy(1, layout.one, one)
    if layout.two + st <= lim["smem_per_block_optin"]:
        two = blocks_per_sm(layout.threads, layout.two, st, regs, lim)
        if two >= 1 and two >= one:
            return Occupancy(2, layout.two, two)
    return Occupancy(1, layout.one, one)


def _counter_copies(words: int, budget: int) -> int:
    """``sm90::counter_copies``: copies of the counters while they fit."""
    copies = 32
    while copies > 1 and copies * (words | 1) > budget:
        copies >>= 1
    return copies


def kernel_layout(kernel: str, tile: int, m: int, *, segments: Optional[int] = None,
                  key_value: bool = False, ids: bool = False, packed: bool = False,
                  form: str = "shift", pair_bits: Optional[int] = None) -> KernelLayout:
    """The shared memory and block shape of the kernel wrapper ``kernel`` at
    ``tile`` keys a tile and ``m`` buckets (a fused pair: ``pair_bits``),
    as its launcher sizes them (``csrc/*.cu``: ``Layout``, ``smem_bytes``,
    the ``one`` / ``two`` stage sizes of ``sm90::pick_stages``). ``ids``
    marks a packed kernel on an ids strip (the onehot ids kernels carry it in
    their names), ``packed`` a fused pair's packed stage rank. ``form`` is
    the label form (``shift``, ``clamp`` or ``any``; an ids strip is read in
    the clamp form), which sets some kernels' register budget."""
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"the CUDA kernels take tiles of 1..{MAX_TILE} keys, got {tile}")
    pitch = (tile + 3) & ~3
    m4 = (m + 3) & ~3
    kv = int(key_value)
    seg = segments is not None
    rounds16 = tile <= 16 * 32 * _WARPS           # kR = 16, else 32
    vec = 1 if tile <= 4 * 512 else (2 if tile <= 8 * 512 else 4)
    general = form == "any" and not ids
    ids = ids or kernel in ("tile_histograms", "tile_positions", "fused_postscan_reorder",
                            "seg_tile_histograms", "seg_tile_positions",
                            "seg_fused_postscan_reorder")
    name = kernel.replace("spec_", "")
    if name == "tile_histograms":                                   # K1
        copies = _counter_copies(m, _K1_COPY_WORDS)
        return KernelLayout(kernel, 512, 4 if vec <= 2 else 2, 4 * 2 * copies * (m | 1), None,
                            4 * _MAX_BUCKETS)
    if name == "seg_tile_histograms":                               # K1s
        return KernelLayout(kernel, 512, {1: 3, 2: 4, 4: 2}[vec], 4 * 2 * _K1S_SET_WORDS, None,
                            4 * _MAX_BUCKETS + 16)
    if name == "packed_tile_histograms":                            # K1p
        return KernelLayout(kernel, 512, 2 if vec == 4 else (3 if seg else 4),
                            4 * 2 * _K1P_SET_WORDS, None, 4 * _MAX_BUCKETS + 16)
    if name == "fused2_tile_histograms":                            # K1f
        m2 = 1 << pair_bits
        win = min(segments or 1, max(_K1F_WINDOW_CELLS // m2, 1))
        return KernelLayout(kernel, _K1F_BLOCK, 1, win * m2 // 2 * 4, None,
                            2 * 4 * (_K1F_BLOCK // 32))
    if name == "fused_postscan_reorder":                            # K2
        words = (1 + kv + int(ids)) * pitch + m4
        fixed = 4 * (_WARPS * m + m) + pitch
        return KernelLayout(kernel, 256, 2 if rounds16 else 1, 4 * words + fixed,
                            4 * 2 * words + fixed, 4 * _MAX_BUCKETS + 4 * _WARPS)
    if name == "tile_positions":                                    # K3
        words = pitch + m4
        one = 4 * words + 4 * _WARPS * m
        mb = (3 if general else 4) if rounds16 else (1 if general else 2)
        return KernelLayout(kernel, 256, mb, one, one + 4 * words, 4 * _MAX_BUCKETS)
    if name == "seg_fused_postscan_reorder":                        # K2s
        stage = 4 * (2 + kv + int(ids)) * pitch
        one = stage + 4 * (_WARPS * m + m)
        return KernelLayout(kernel, 256, 2 if rounds16 else 1, one, one + stage,
                            4 * _MAX_BUCKETS + 4 * _WARPS + _SEG_STATIC)
    if name == "seg_tile_positions":                                # K3s
        words = pitch + max(pitch, m4)
        one = 4 * words + 4 * _WARPS * m
        mb = (3 if general else 4) if rounds16 else (1 if general else 2)
        return KernelLayout(kernel, 256, mb, one, one + 4 * words,
                            4 * _MAX_BUCKETS + _SEG_STATIC + 24)
    packed_static = 4 * _MAX_BUCKETS + 4 * _WARPS * (_MAX_BUCKETS // 4) + (
        _SEG_STATIC if seg else 16)
    if name == "packed_fused_postscan_reorder":                     # K2p
        stage = 4 * (1 + kv + int(ids) + int(seg or not ids)) * pitch
        one = stage + 4 * (_WARPS * m + m) + (0 if seg else pitch)
        return KernelLayout(kernel, 256, 2 if rounds16 else 1, one, one + stage,
                            packed_static + 4 * _WARPS)
    if name == "packed_tile_positions":                             # K3p
        words = pitch + (pitch if seg and pitch > m4 else m4)
        one = 4 * words + 4 * _WARPS * m
        mb = 4 if rounds16 else (1 if general else 2)
        return KernelLayout(kernel, 256, mb, one, one + 4 * words, packed_static + 24)
    if name in ("fused2_fused_postscan_reorder", "fused2_tile_positions"):   # K2f, K3f
        one = 4 * (3 * pitch + _WARPS * _MAX_BUCKETS + _FUSED2_MAX_ROUNDS)
        return KernelLayout(kernel, 256, 2, one, one + 4 * pitch,
                            4 * _WARPS + (4 * _WARPS * (_MAX_BUCKETS // 4) if packed else 4)
                            + (_SEG_STATIC if seg else 16))
    raise ValueError(f"no shared-memory model for kernel {kernel!r}")


def plan_kernels(tile: int, m: int, *, method: str = "bms", mode: str = "reorder",
                 key_value: bool = False, segments: Optional[int] = None,
                 family: str = "onehot", ids: bool = False, form: str = "shift",
                 pair_bits: Optional[int] = None) -> Tuple[KernelLayout, ...]:
    """The kernels one cuda plan launches (its prescan, and its postscan
    unless ``mode`` is ``counts_only``), each with its
    :class:`KernelLayout` at ``tile``. ``ids`` selects the kernels on a
    materialised ids strip; ``pair_bits`` a fused pair (K1f, K2f / K3f)."""
    kw = dict(segments=segments, key_value=key_value, form="clamp" if ids else form,
              pair_bits=pair_bits, packed=family == "packed")
    seg = "seg_" if segments is not None else ""
    positions = method == "dms" or mode == "positions_only"
    if pair_bits is not None:
        pre, post = "fused2_tile_histograms", (
            "fused2_tile_positions" if positions else "fused2_fused_postscan_reorder")
    elif family == "packed":
        pre = "packed_tile_histograms"
        post = "packed_tile_positions" if positions else "packed_fused_postscan_reorder"
        kw["ids"] = ids
    else:
        lab = "" if ids else "spec_"
        pre = f"{seg}{lab}tile_histograms"
        post = f"{seg}{lab}tile_positions" if positions else f"{seg}{lab}fused_postscan_reorder"
    names = (pre,) if mode == "counts_only" else (pre, post)
    return tuple(kernel_layout(k, tile, m, **kw) for k in names)


def label_form(spec: BucketSpec, key_dtype: torch.dtype = torch.int32) -> str:
    """The form the kernels evaluate ``spec``'s label in
    (``sm90::make_label``): ``shift`` for a BitfieldSpec and a DeltaSpec
    over 2^k on integer keys, ``clamp`` for an IdentitySpec on integer keys,
    ``any`` otherwise."""
    from repro_torch.core.identifiers import BitfieldSpec, DeltaSpec, IdentitySpec

    integer = not key_dtype.is_floating_point
    if isinstance(spec, BitfieldSpec):
        return "shift"
    if isinstance(spec, DeltaSpec) and spec.delta & (spec.delta - 1) == 0 and integer:
        return "shift"
    if isinstance(spec, IdentitySpec) and integer:
        return "clamp"
    return "any"


def plan_occupancy(tile: int, bucket_fn: BucketSpec, *, method: str = "bms",
                   key_value: bool = False, segments: Optional[int] = None,
                   family: str = "onehot", pair_bits: Optional[int] = None,
                   device=None) -> Tuple[Tuple[str, Occupancy], ...]:
    """(kernel, :class:`Occupancy`) of each kernel of one cuda plan over
    ``bucket_fn``'s labels at ``tile`` (a fused pair: ``pair_bits``, its
    ``BitfieldSpec``). On a CUDA ``device`` the launchers' own reports
    (``multisplit_tile.launch_report``: the compiler's registers and the
    occupancy API, no launch); elsewhere the model's, with the register
    ceiling of each kernel's ``__launch_bounds__``."""
    m = 1 << pair_bits if pair_bits is not None else bucket_fn.num_buckets
    lays = plan_kernels(tile, m, method=method, key_value=key_value, segments=segments,
                        family=family, form=label_form(bucket_fn), pair_bits=pair_bits)
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        limits = device_limits(dev)
        return tuple((lay.kernel, occupancy(lay, limits=limits)) for lay in lays)
    from repro_torch.kernels import multisplit_tile as _mst

    out = []
    with torch.cuda.device(dev):
        for lay in lays:
            rep = _mst.launch_report(lay.kernel, tile, bucket_fn, num_segments=segments,
                                     key_value=key_value, family=family)
            out.append((lay.kernel, Occupancy(rep["stages"], rep["smem"], rep["blocks"])))
    return tuple(out)


def _blocks_note(occs) -> str:
    """``K b blocks an SM (stages, KiB)`` for each (kernel, occupancy)."""
    return "; ".join(f"{kernel} {occ.blocks} blocks an SM ({occ.stages} stage"
                     f"{'s' if occ.stages > 1 else ''}, {occ.smem / 1024:.1f} KiB)"
                     for kernel, occ in occs)


def _launchable(occs) -> bool:
    return all(occ.blocks >= 1 for _, occ in occs)


# ---------------------------------------------------------------------------
# Heuristics, resolvers and caches
# ---------------------------------------------------------------------------

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


_PACKED_SLOWER = (
    "every packed kernel is slower than its onehot twin on the H100 (NVIDIA H100 80GB HBM3, "
    "700 W; PERF.md §6-§7): K1p 0.0576 ms against 0.0553 on K1's int32 copies, K2p "
    "0.4481 against K2's 0.3707-0.3737, K3p / K3 1.49x at m = 256 and 1.22-1.29x at "
    "m = 8 and 32, K3p / K3s 1.28x at S1, and the flat packed key-value bms call "
    "1.471 ms against the onehot 1.379"
)


def _heuristic_family(n: int, m: int, method: str, backend: str) -> Tuple[str, str]:
    be = get_backend(backend)
    if not be.tiled:
        return "onehot", "untiled direct-solve backend: no tile local solve"
    if "packed" not in be.families:
        return "onehot", f"backend {backend!r} advertises no packed support"
    cpu_era = ("the JAX crossover, packed from m_eff >= 8, was measured on a CPU host and is "
               "not the port's")
    if be.uses_kernels:
        return "onehot", f"m_eff={m}: onehot, because {_PACKED_SLOWER}; {cpu_era}"
    return "onehot", (
        f"m_eff={m}: onehot, the cuda backend's default measured on the H100 (both families' "
        f"plain bodies give the same bits); {cpu_era}"
    )


def resolve_kernel_family(
    n: int, m: int, method: str, backend: str, requested: Optional[str] = None,
    digits: int = 1, key_value: bool = False, pair_m: Optional[int] = None,
) -> str:
    """The kernel family of one shape (``m`` is ``m_eff``, or the stage
    width of a fused pair with ``digits=2``), cached per shape with the
    reason it was chosen (:func:`family_decision`). An explicit
    ``requested`` family is validated against :data:`FAMILIES` and the
    backend's ``families`` and returned as it is, never cached: a one-off
    override does not change what later plans of the shape resolve to.
    ``key_value`` and ``pair_m`` tell an armed autotuner what to measure;
    they are not part of the key."""
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
        from repro_torch.core.pipeline import autotune as _at

        _at.maybe_tune_family(n, m, method, backend, digits=digits, key_value=key_value,
                              pair_m=pair_m)
        hit = _FAMILY_CACHE.get(key)          # the search pins on success
    if hit is None:
        hit = _heuristic_family(n, m, method, backend)
        if not _deferred():
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


def _stage_m(m: int, digits: int, stage_m: Optional[int]) -> int:
    return m if digits == 1 else (stage_m or max(1, int(m ** 0.5)))


def resolve_tile(
    n: int, m: int, method: str, key_value: bool, backend: str,
    requested: Optional[int] = None, digits: int = 1, stage_m: Optional[int] = None,
    family: Optional[str] = None,
) -> int:
    """Tile height for one shape, cached per shape; ``m`` is the scan width
    ``m_eff`` (``s·m`` for segmented plans, ``s·m²`` for a fused pair with
    ``digits=2`` and its stage width ``stage_m``). An explicit request is
    returned as it is and never cached. A plan of an explicit ``family``
    other than the one its shape resolves to takes the default tile,
    uncached."""
    if requested is not None:
        if requested < 1:
            raise ValueError(f"tile must be >= 1, got {requested}")
        return requested
    fam_m = _stage_m(m, digits, stage_m)
    if family is None:
        auto = resolve_kernel_family(n, fam_m, method, backend, digits=digits,
                                     key_value=key_value, pair_m=None if digits == 1 else m)
    else:
        # an explicit family caches nothing: read the shape's family, else
        # its default, without resolving it
        hit = _FAMILY_CACHE.get(_family_key(n, fam_m, method, backend, digits))
        auto = hit[0] if hit else _heuristic_family(n, fam_m, method, backend)[0]
        if family != auto:
            return _heuristic_tile(n, m, method, backend, digits)
    key = _tile_key(n, m, method, key_value, backend, digits, stage_m)
    tile = _TILE_CACHE.get(key)
    if tile is None:
        from repro_torch.core.pipeline import autotune as _at

        _at.maybe_tune_tile(n, m, method, key_value, backend, digits=digits, stage_m=stage_m,
                            family=auto)
        tile = _TILE_CACHE.get(key)           # the search pins on success
    if tile is None:
        tile = _heuristic_tile(n, m, method, backend, digits)
        if not _deferred():
            _TILE_CACHE[key] = tile
    return tile


def _deferred() -> bool:
    """An armed autotuner's miss inside a trace takes the default without
    pinning it (``autotune.tracing``)."""
    from repro_torch.core.pipeline import autotune as _at

    return _at.armed() and _at.tracing()


def tile_decision(
    n: int, m: int, method: str, key_value: bool, backend: str, digits: int = 1,
    stage_m: Optional[int] = None,
) -> Tuple[int, str]:
    """(tile, reason) of one shape, resolved (and cached) first if need be.
    On ``cuda`` the reason names the blocks an SM of each kernel of the
    shape's key-value or key-only plan (:func:`plan_occupancy`: the card's
    reports where a card is present, else the model's)."""
    tile = resolve_tile(n, m, method, key_value, backend, digits=digits, stage_m=stage_m)
    key = _tile_key(n, m, method, key_value, backend, digits, stage_m)
    reason = _TILE_REASONS.get(key)
    if reason is None:
        if get_backend(backend).uses_kernels:
            reason = (f"the cuda tile (CUDA_TILE = {CUDA_TILE}, FUSED2_CUDA_TILE = "
                      f"{FUSED2_CUDA_TILE}; a smaller n is one tile): "
                      f"{_shape_note(tile, m, method, key_value, digits, stage_m)}")
        else:
            reason = "the plain bodies' tile (the JAX package's warp and block tiles)"
    return tile, reason


def _shape_note(tile: int, m: int, method: str, key_value: bool, digits: int,
                stage_m: Optional[int]) -> str:
    """The blocks an SM of a flat plan over ``DeltaSpec(m)``'s buckets (a
    pair of ``m`` cells), where the kernels take the shape."""
    from repro_torch.core.identifiers import DeltaSpec

    if tile > MAX_TILE:
        return f"tile {tile} is above MAX_TILE = {MAX_TILE}"
    card = torch.device("cuda") if torch.cuda.is_available() else None
    if digits == 2:
        if m & (m - 1) or m > 1 << 16:
            return "no model for a pair of this width"
        bits = m.bit_length() - 1
        occs = plan_occupancy(tile, BitfieldSpec(0, bits), method=method, key_value=key_value,
                              pair_bits=bits, device=card)
    else:
        if m > _MAX_BUCKETS:
            return f"m_eff={m} runs the segmented kernels, their m-wide state per segment"
        occs = plan_occupancy(tile, DeltaSpec(m), method=method, key_value=key_value,
                              device=card)
    return _blocks_note(occs)


def resolve_sub_bits(
    n: int, m: int, method: str, key_value: bool, backend: str, stage_m: int,
    requested: Optional[int] = None,
) -> Optional[int]:
    """The in-tile stage width of a fused-pair plan: the request, else the
    width the autotuner measured for the shape (or read from disk), else
    None, which leaves the width to the stage bodies: the cuda kernels'
    ``CUDA_SUB_BITS = 8`` (measured on the H100, PERF.md §6: K2f key-value
    2.5706 ms at 8 bits against 2.9508 at 4, K3f 1.9733 against 2.3833), the
    plain bodies' ``FUSED2_SUB_BITS``. ``m`` is the pair's scan width and
    ``stage_m`` its stage width. Every width gives the same bits."""
    if requested is not None:
        return requested
    key = (n, m, method, key_value, backend, stage_m)
    hit = _SUB_BITS_CACHE.get(key)
    if hit is None:
        from repro_torch.core.pipeline import autotune as _at

        _at.maybe_tune_sub_bits(n, m, method, key_value, backend, stage_m)
        hit = _SUB_BITS_CACHE.get(key)
    return hit


def pin_tile(n: int, m: int, method: str, key_value: bool, backend: str, tile: int, *,
             digits: int = 1, stage_m: Optional[int] = None) -> None:
    """Pin one tile in the per-shape cache, as a measured fact of the shape
    (an explicit tile on a plan stays uncached)."""
    key = _tile_key(n, m, method, key_value, backend, digits, stage_m)
    _TILE_CACHE[key] = int(tile)
    _TILE_REASONS[key] = f"pinned by pin_tile ({int(tile)})"


# callables that drop what a layer above cached from these decisions (a
# plan holds its resolved tile) or loaded beside the autotune file;
# clear_tile_cache(disk) runs them all with its disk flag
_CLEAR_HOOKS: List[Callable[[bool], None]] = []


def on_clear(hook: Callable[[bool], None]) -> None:
    """Have :func:`clear_tile_cache` call ``hook(disk)``: a layer that
    caches plans registers how to drop them, so a re-resolved tile reaches
    it; a layer with a file beside the autotune file, how to forget its
    loaded snapshot (and, under ``disk``, delete the file)."""
    if hook not in _CLEAR_HOOKS:
        _CLEAR_HOOKS.append(hook)


def clear_tile_cache(disk: bool = False) -> None:
    """Drop every cached tile, family, stage-width and label-fusion decision,
    what the :func:`on_clear` hooks cached with them (the plans of ``ops``),
    and the loaded snapshots of the autotune file and of the resilience
    layer's quarantine sidecar, so the next miss reads the files again (what
    a fresh process would see: a quarantined plan class survives).
    ``disk=True`` deletes both files as well."""
    from repro_torch.core.pipeline import autotune as _at
    from repro_torch.core.pipeline import spec as _spec

    _TILE_CACHE.clear()
    _TILE_REASONS.clear()
    _FAMILY_CACHE.clear()
    _SUB_BITS_CACHE.clear()
    _spec._FUSION_CACHE.clear()
    for hook in _CLEAR_HOOKS:
        hook(disk)
    if disk:
        _at.clear_disk()
    else:
        _at.drop_loaded()


def autotune_tile(
    n: int,
    bucket_fn: BucketSpec,
    *,
    method: str = "bms",
    key_value: bool = False,
    backend: str = "cuda",
    candidates: Tuple[int, ...] = (256, 512, 1024, 2048, 4096),
    families: Optional[Tuple[str, ...]] = None,
    trials: int = 3,
    seed: int = 0,
    segments: Optional[int] = None,
    batch: Optional[int] = None,
    device=None,
) -> int:
    """Time the candidate (tile, family) grid on keys made from ``seed``
    over the spec's own key range (``autotune.synthetic_inputs``) and pin both winners in the per-shape caches (the family and
    the tile with reasons that name the times, the tile's also the blocks
    an SM of its kernels), persisting them when the autotune disk layer is
    active. Returns the tile; :func:`family_decision` reads the family.

    ``segments=s`` / ``batch=b`` measure the segmented (even segments) or
    batched layout (the keys of an IdentitySpec are ids in [0, m)). On the
    cuda backend a (tile, family) pair that some kernel of its plan cannot
    launch is dropped before any timing (:func:`plan_occupancy`: the
    launchers' reports on the card, the model elsewhere); a candidate that
    fails to build or launch raises. ``device`` is where the search
    runs (default: the card if there is one); every trial ends in a
    synchronisation of it. Each candidate's seconds are kept in
    ``autotune.last_times()``."""
    from repro_torch.core.pipeline import autotune as _at
    from repro_torch.core.pipeline.spec import make_plan

    be = get_backend(backend)
    if families is None:
        families = be.families if be.tiled else ("onehot",)
    m = bucket_fn.num_buckets
    m_eff = m * (segments or 1)
    for fam in families:
        resolve_kernel_family(n, m_eff, method, backend, fam)
    dev = _at.search_device(device)
    keys, values, starts = _at.synthetic_inputs(n, bucket_fn, key_value=key_value, batch=batch,
                                                segments=segments, device=dev, seed=seed)
    times, notes = [], {}
    with _at.searching():
        for tile in candidates:
            if tile > max(n, _MIN_TILE) or (be.uses_kernels and tile > MAX_TILE):
                continue
            for fam in families:
                if be.uses_kernels:
                    occs = plan_occupancy(tile, bucket_fn, method=method, key_value=key_value,
                                          segments=segments, family=fam, device=dev)
                    if not _launchable(occs):
                        continue                # no kernel of it can launch
                    notes[tile, fam] = _blocks_note(occs)
                plan = make_plan(n, m, method=method, key_value=key_value, backend=backend,
                                 tile=tile, bucket_fn=bucket_fn, family=fam, segments=segments,
                                 batch=batch)
                run = (lambda p=plan: p(keys, values)) if starts is None else (
                    lambda p=plan: p(keys, values, segment_starts=starts))
                times.append((tile, fam, _at.time_call(run, trials, dev)))
    _at.note_times(times)
    if not times:
        return resolve_tile(n, m_eff, method, key_value, backend)
    best_s, best_t, best_f = min((s, t, f) for t, f, s in times)
    grid = f"tiles={tuple(candidates)} x families={tuple(families)}"
    tkey = _tile_key(n, m_eff, method, key_value, backend, 1, None)
    _TILE_CACHE[tkey] = best_t
    _TILE_REASONS[tkey] = (f"autotuned over {grid}: {best_t} won at {best_s:.3e}s"
                           + (f"; {notes[best_t, best_f]}" if (best_t, best_f) in notes else ""))
    # the family is shared by both key-value variants of the shape, but only
    # this variant's tile was measured under it: the other re-resolves
    _TILE_CACHE.pop(_tile_key(n, m_eff, method, not key_value, backend, 1, None), None)
    _TILE_REASONS.pop(_tile_key(n, m_eff, method, not key_value, backend, 1, None), None)
    fkey = _family_key(n, m_eff, method, backend, 1)
    _FAMILY_CACHE[fkey] = (best_f, f"autotuned over {grid}: ({best_t}, {best_f!r}) won at "
                                   f"{best_s:.3e}s")
    _at.record("tile", tkey, best_t, dev)
    _at.record("family", fkey, best_f, dev)
    return best_t
