"""The self-tuning layer (counterpart of ``repro/core/pipeline/autotune.py``):
autotune on a cache's first miss, and a persistent cache of every tuned
decision.

* **Opt-in.** ``repro_torch.ops.set_autotune(True)`` (or ``REPRO_AUTOTUNE=1``
  in the environment) arms the layer. Disarmed, every resolver keeps its
  measured default and this module does nothing: no timing, no file I/O.
* **On-miss hooks.** Armed, a miss in the tile, family, stage-width or
  label-fusion cache first reads the persistent cache and otherwise runs
  the matching timing search (:func:`~repro_torch.core.pipeline.tiles.
  autotune_tile` for the joint (tile, family) grid, :func:`autotune_fused2`
  for a fused pair's (tile, family, stage width) grid,
  :func:`autotune_label_fusion` for the ``vmap`` label-fusion choice),
  pinning and persisting the winner. A family miss runs the joint search, a
  tile miss searches tiles under the family already resolved. The hooks
  measure the flat layout of the shape's scan width for segmented and
  batched plans; ``autotune_tile(segments=, batch=)`` measures those
  layouts themselves.
* **Persistence.** One JSON file, ``multisplit_autotune_torch.json`` (its
  own name, so the JAX package's file is never rewritten), under
  ``set_autotune(cache_dir=)``, ``$REPRO_AUTOTUNE_DIR`` or
  ``~/.cache/repro-multisplit``, replaced atomically, read lazily, keyed by
  (device fingerprint, kind, the in-memory cache key). A file of another
  ``SCHEMA_VERSION``, or a corrupt one, loads as empty; only file I/O fails
  quietly. A candidate that fails to build or launch raises.
* **Search scope.** The searches build and run plans themselves, so while
  one runs (``_IN_SEARCH``) every hook is inert and the candidates resolve
  through their explicit arguments only. On the card each trial ends in
  ``torch.cuda.synchronize()`` after one warm-up call that also builds the
  kernels; on the CPU the trials are timed by ``time.perf_counter``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import platform
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

SCHEMA_VERSION = 1
CACHE_FILE = "multisplit_autotune_torch.json"

_ENV_FLAG = "REPRO_AUTOTUNE"
_ENV_DIR = "REPRO_AUTOTUNE_DIR"


def _env_enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "").strip().lower() in ("1", "true", "on")


@dataclasses.dataclass(frozen=True)
class AutotuneConfig:
    """The armed or disarmed state of the self-tuning layer.

    ``persist=None`` follows ``enabled``: the disk layer is active exactly
    when autotuning is. ``persist=False`` tunes in memory only; ``True``
    reads and writes the file even while the searches stay off."""

    enabled: bool = False
    cache_dir: Optional[str] = None
    persist: Optional[bool] = None
    trials: int = 3
    candidates: Tuple[int, ...] = (256, 512, 1024, 2048, 4096)


_CONFIG = AutotuneConfig(enabled=_env_enabled())

# The reentrancy latch: while a search measures, every hook is inert.
_IN_SEARCH = False

# The loaded snapshot of the file ({key: value}), or None before it is read
# (drop_loaded() resets it, as a fresh process would start).
_LOADED: Optional[dict] = None

_FINGERPRINTS: dict = {}

# (tile, family[, sub_bits], seconds) of each candidate of the last search,
# and the number of timing searches run in this process
_LAST_TIMES: List[tuple] = []
_SEARCHES = 0


def set_autotune(enabled=None, *, cache_dir=None, persist=None, trials=None, candidates=None):
    """Arm or disarm autotuning on a cache's first miss and configure the
    persistent cache. An argument left None keeps its value; returns the new
    :class:`AutotuneConfig`. ``enabled=True`` makes a miss in the tile,
    family, stage-width or label-fusion resolvers read the file and
    otherwise run the timing search; ``cache_dir`` sets where the file lives
    (default ``$REPRO_AUTOTUNE_DIR`` or ``~/.cache/repro-multisplit``);
    ``trials`` and ``candidates`` bound the searches the misses run."""
    global _CONFIG, _LOADED
    kw = {}
    if enabled is not None:
        kw["enabled"] = bool(enabled)
    if cache_dir is not None:
        kw["cache_dir"] = str(cache_dir)
        _LOADED = None                      # read the new location afresh
    if persist is not None:
        kw["persist"] = bool(persist)
    if trials is not None:
        kw["trials"] = int(trials)
    if candidates is not None:
        kw["candidates"] = tuple(int(c) for c in candidates)
    _CONFIG = dataclasses.replace(_CONFIG, **kw)
    return _CONFIG


def autotune_status() -> dict:
    """The active configuration, the cache file, its entry count and the
    device fingerprint."""
    ent = _entries() if _persist_active() else {}
    return {
        "config": _CONFIG,
        "cache_path": str(cache_path()),
        "disk_entries": len(ent),
        "fingerprint": host_fingerprint(),
    }


def active() -> bool:
    """True when a miss may run a timing search now: never inside a search,
    and never inside a dry-run's trace (:func:`tracing`)."""
    return _CONFIG.enabled and not _IN_SEARCH and not tracing()


def tracing() -> bool:
    """A trace is in force: a ``FakeTensorMode`` (a search on fake tensors
    would time nothing) or a counting mode (``launch.hlo_analysis``), whose
    counts a search's trials would join. A miss then takes the default and
    pins nothing, so the shape is still searched outside the trace."""
    from torch._guards import detect_fake_mode

    from repro_torch.kernels import build

    return bool(build.WORK_SINKS) or detect_fake_mode() is not None


def armed() -> bool:
    """True when autotuning is opted in, even inside a search: a resolver
    that would pin a default defers instead, so the shape stays measurable."""
    return _CONFIG.enabled


def _persist_active() -> bool:
    return _CONFIG.enabled if _CONFIG.persist is None else _CONFIG.persist


def search_device(device=None) -> torch.device:
    """Where a search runs: ``device``, else the current card, else the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def host_fingerprint(device=None) -> str:
    """The machine and the device the search runs on, for the file's keys:
    a tuned tile is a fact of the card, not of the repository.
    ``platform.machine()`` with the card's name and compute capability, or
    ``cpu``."""
    dev = search_device(device)
    key = (dev.type, dev.index)
    if key not in _FINGERPRINTS:
        if dev.type == "cuda":
            major, minor = torch.cuda.get_device_capability(dev)
            accel = f"cuda-{torch.cuda.get_device_name(dev)}-sm{major}{minor}"
        else:
            accel = "cpu"
        raw = f"{platform.machine()}-{accel}"
        _FINGERPRINTS[key] = raw.replace(" ", "_").replace("|", "_")
    return _FINGERPRINTS[key]


def cache_path() -> Path:
    base = _CONFIG.cache_dir or os.environ.get(_ENV_DIR) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-multisplit"
    )
    return Path(base) / CACHE_FILE


def _key_str(kind: str, mem_key: Tuple, device=None) -> str:
    """fingerprint | kind | the in-memory cache key: the file and the caches
    name a shape class the same way."""
    parts = "|".join(str(x) for x in mem_key)
    return f"{host_fingerprint(device)}|{kind}|{parts}"


def _entries() -> dict:
    """The loaded snapshot. A missing, unreadable, corrupt or old-schema
    file loads as empty."""
    global _LOADED
    if _LOADED is None:
        _LOADED = {}
        try:
            with open(cache_path()) as f:
                raw = json.load(f)
            if (isinstance(raw, dict) and raw.get("version") == SCHEMA_VERSION
                    and isinstance(raw.get("entries"), dict)):
                _LOADED = dict(raw["entries"])
        except (OSError, ValueError):
            pass
    return _LOADED


def _flush(entries: dict) -> None:
    """Write the file whole (a temporary file beside it, then
    ``os.replace``); a directory that cannot be written leaves the tuning in
    memory."""
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".autotune-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": SCHEMA_VERSION, "entries": entries}, f, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except OSError:
        pass


def record(kind: str, mem_key: Tuple, value, device=None) -> None:
    """Persist one tuned decision (nothing while the disk layer is off)."""
    if not _persist_active():
        return
    ent = _entries()
    ent[_key_str(kind, mem_key, device)] = value
    _flush(ent)


def lookup(kind: str, mem_key: Tuple, device=None):
    """One persisted decision, or None."""
    if not _persist_active():
        return None
    return _entries().get(_key_str(kind, mem_key, device))


def drop_loaded() -> None:
    """Forget the loaded snapshot; the next lookup reads the file again."""
    global _LOADED
    _LOADED = None


def clear_disk() -> None:
    """Delete the file (and the loaded snapshot)."""
    global _LOADED
    _LOADED = {}
    try:
        os.remove(cache_path())
    except OSError:
        pass


_DISK_REASON = "autotuned (persistent cache hit)"


@contextlib.contextmanager
def searching():
    """Mark a timing search: the hooks stay inert inside it."""
    global _IN_SEARCH, _SEARCHES
    outer = _IN_SEARCH
    _IN_SEARCH = True
    _SEARCHES += 1
    try:
        yield
    finally:
        _IN_SEARCH = outer


def time_call(fn, trials: int, device) -> float:
    """The least of ``trials`` timed calls of ``fn`` after one warm-up call
    (which builds the kernels); on the card each call ends in a
    synchronisation of it."""
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    fn()
    sync()
    best = float("inf")
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def note_times(times) -> None:
    """Keep the candidates' times of the search that just ran."""
    _LAST_TIMES[:] = list(times)


def last_times() -> List[tuple]:
    """(tile, family[, sub_bits], seconds) of each candidate of the last
    search."""
    return list(_LAST_TIMES)


# ---------------------------------------------------------------------------
# The on-miss hooks (called by the resolvers of tiles.py and spec.py)
# ---------------------------------------------------------------------------

def _pair_geometry(pair_m: int, stage_m: int) -> Optional[Tuple[int, int]]:
    """(bits, split) of a fused pair from its widths, or None where they are
    not powers of two within the kernels' pairs (a segmented pair): then no
    schedule follows and the default stands."""
    if pair_m <= 0 or stage_m <= 0 or pair_m & (pair_m - 1) or stage_m & (stage_m - 1):
        return None
    bits, split = pair_m.bit_length() - 1, stage_m.bit_length() - 1
    if not 0 < split < bits <= 16:
        return None
    return bits, split


def _proxy_spec(m: int):
    """The spec the hooks measure a shape class with (the JAX package's)."""
    from repro_torch.core.identifiers import EvenSpec

    return EvenSpec(0.0, float(1 << 30), m)


def maybe_tune_family(n: int, m: int, method: str, backend: str, *, digits: int = 1,
                      key_value: bool = False, pair_m: Optional[int] = None) -> None:
    """Family miss: a disk hit pins the family; otherwise the joint search
    pins the family and its tile together."""
    if not active():
        return
    from repro_torch.core.pipeline import tiles as _t
    from repro_torch.core.pipeline.registry import get_backend

    fkey = _t._family_key(n, m, method, backend, digits)
    fam = lookup("family", fkey)
    if fam is not None:
        _t._FAMILY_CACHE[fkey] = (str(fam), _DISK_REASON)
        return
    be = get_backend(backend)
    if not be.tiled or (digits == 1 and m > 256 and be.uses_kernels):
        return                # the oracle, or a segmented width: no flat proxy to time
    if digits == 1:
        _t.autotune_tile(n, _proxy_spec(m), method=method, key_value=key_value,
                         backend=backend, candidates=_CONFIG.candidates,
                         trials=_CONFIG.trials)
        return
    geom = _pair_geometry(pair_m or 0, m)
    if geom is not None:
        autotune_fused2(n, 0, *geom, method=method, key_value=key_value, backend=backend,
                        trials=_CONFIG.trials)


def maybe_tune_tile(n: int, m: int, method: str, key_value: bool, backend: str, *,
                    digits: int = 1, stage_m: Optional[int] = None,
                    family: Optional[str] = None) -> None:
    """Tile miss (the family resolved): a disk hit pins the tile; otherwise
    the search over tiles under that family."""
    if not active():
        return
    from repro_torch.core.pipeline import tiles as _t
    from repro_torch.core.pipeline.registry import get_backend

    tkey = _t._tile_key(n, m, method, key_value, backend, digits, stage_m)
    tile = lookup("tile", tkey)
    if tile is not None:
        _t._TILE_CACHE[tkey] = int(tile)
        _t._TILE_REASONS[tkey] = _DISK_REASON
        return
    be = get_backend(backend)
    if not be.tiled or (digits == 1 and m > 256 and be.uses_kernels):
        return
    families = None if family is None else (family,)
    if digits == 1:
        _t.autotune_tile(n, _proxy_spec(m), method=method, key_value=key_value,
                         backend=backend, families=families,
                         candidates=_CONFIG.candidates, trials=_CONFIG.trials)
        return
    geom = _pair_geometry(m, stage_m or 0)
    if geom is not None:
        autotune_fused2(n, 0, *geom, method=method, key_value=key_value, backend=backend,
                        families=families, trials=_CONFIG.trials)


def maybe_tune_sub_bits(n: int, m: int, method: str, key_value: bool, backend: str,
                        stage_m: int) -> None:
    """Stage-width miss: from the file only; the fused-pair search, which
    the family and tile hooks reach, is what measures it."""
    if not _CONFIG.enabled:
        return
    from repro_torch.core.pipeline import tiles as _t

    key = (n, m, method, key_value, backend, stage_m)
    val = lookup("sub_bits", key)
    if val is not None:
        _t._SUB_BITS_CACHE[key] = int(val)


def maybe_tune_fusion(spec):
    """Label-fusion miss on ``vmap``: a disk hit, else the fused and
    materialised plans timed on keys of the plan's own shape. Returns the
    pinned ``(fused?, reason)``, or None when disarmed or inside a search."""
    if not active():
        return None
    from repro_torch.core.pipeline import spec as _sp

    key = (spec.backend, type(spec.bucket_fn).__name__, spec.m_eff)
    val = lookup("fusion", key)
    if val is not None:
        hit = (bool(val), _DISK_REASON)
        _sp._FUSION_CACHE[key] = hit
        return hit
    return autotune_label_fusion(spec, trials=_CONFIG.trials)


# ---------------------------------------------------------------------------
# The label-fusion and fused-pair searches
# ---------------------------------------------------------------------------

def key_bounds(bucket_fn) -> Tuple[int, int]:
    """[lo, hi) of a search's synthetic keys: the spec's own key range, so
    that every bucket it has is live (how many are shapes the cost of the
    local solve). The ids [0, m) of an IdentitySpec, [0, key_max) of a
    DeltaSpec (up to the whole uint32 range), the bits up to a BitfieldSpec's
    top digit, an EvenSpec's [lo, hi) where it lies in the non-negative
    int32 range; else [0, 2^30), the JAX package's range for every spec."""
    from repro_torch.core.identifiers import BitfieldSpec, DeltaSpec, EvenSpec, IdentitySpec

    if isinstance(bucket_fn, IdentitySpec):
        return 0, bucket_fn.num_buckets
    if isinstance(bucket_fn, DeltaSpec):
        return 0, min(bucket_fn.key_max, 1 << 32)
    if isinstance(bucket_fn, BitfieldSpec):
        return 0, 1 << min(bucket_fn.shift + bucket_fn.bits, 32)
    if isinstance(bucket_fn, EvenSpec) and 0 <= bucket_fn.lo < bucket_fn.hi <= 2.0 ** 31:
        lo, hi = int(np.ceil(bucket_fn.lo)), int(np.ceil(bucket_fn.hi))
        if lo < hi:
            return lo, hi
    return 0, 1 << 30


def synthetic_inputs(n: int, bucket_fn, *, key_value: bool = False,
                     batch: Optional[int] = None, segments: Optional[int] = None,
                     device="cpu", seed: int = 0):
    """(keys, values, segment starts) that a search times a plan on: int32
    keys drawn from ``seed`` over :func:`key_bounds` (a key of 2^31 or
    more as its uint32 bit pattern, which the specs read as uint32), of
    shape ``(n,)`` or ``(batch, n)``; the values ``arange`` for a key-value
    plan, else None; the starts of ``segments`` even segments, else None."""
    lo, hi = key_bounds(bucket_fn)
    rng = np.random.RandomState(seed)
    shape = (n,) if batch is None else (batch, n)
    draw = rng.randint(lo, hi, shape, dtype=np.int64).astype(np.uint32).view(np.int32)
    keys = torch.from_numpy(draw).to(device)
    values = (torch.arange(keys.numel(), dtype=torch.int32, device=device).view(shape)
              if key_value else None)
    starts = None
    if segments is not None:
        starts = ((torch.arange(segments, dtype=torch.int64) * n) // segments).to(
            device=device, dtype=torch.int32)
    return keys, values, starts


def _synthetic_call(spec, device, seed: int = 0):
    """A call of the plan ``spec`` end to end on :func:`synthetic_inputs`."""
    keys, values, starts = synthetic_inputs(spec.n, spec.bucket_fn, key_value=spec.key_value,
                                            batch=spec.batch, segments=spec.segments,
                                            device=device, seed=seed)
    if starts is None:
        return lambda: spec(keys, values)
    return lambda: spec(keys, values, segment_starts=starts)


def autotune_label_fusion(spec, *, trials: int = 3, seed: int = 0, device=None):
    """Time the plan with label fusion forced on and off (the fusion cache
    pinned around each run) and pin and persist the winner, both times in
    its reason. Returns the pinned ``(fused?, reason)``."""
    from repro_torch.core.pipeline import spec as _sp

    bf = spec.bucket_fn
    if bf is None or not bf.fusable:
        return None
    dev = search_device(device)
    key = (spec.backend, type(bf).__name__, spec.m_eff)
    times = {}
    with searching():
        try:
            for fused in (True, False):
                _sp._FUSION_CACHE[key] = (fused, "autotune probe")
                times[fused] = time_call(_synthetic_call(spec, dev, seed), trials, dev)
        finally:
            _sp._FUSION_CACHE.pop(key, None)
    note_times([(None, "fused", times[True]), (None, "materialised", times[False])])
    win = times[True] <= times[False]
    hit = (win, f"autotuned: fused {times[True]:.3e}s against materialised "
                f"{times[False]:.3e}s at m_eff={spec.m_eff} on {spec.backend!r}")
    _sp._FUSION_CACHE[key] = hit
    record("fusion", key, bool(win), dev)
    return hit


def autotune_fused2(
    n: int,
    shift: int,
    bits: int,
    split: int,
    *,
    method: str = "bms",
    key_value: bool = False,
    backend: str = "cuda",
    candidates: Tuple[int, ...] = (1024, 2048, 4096, 8192),
    families: Optional[Tuple[str, ...]] = None,
    sub_bits_candidates: Tuple[int, ...] = (2, 4, 8),
    trials: int = 3,
    seed: int = 0,
    device=None,
) -> Optional[Tuple[int, str, int]]:
    """The joint (tile, family, stage width) search over one fused-pair
    sweep: pins the ``digits=2`` tile and family and the shape's stage
    width, persists all three, and returns the winning ``(tile, family,
    sub_bits)`` (None when nothing ran). On the cuda backend the
    shared-memory model drops tiles the kernels cannot launch first."""
    from repro_torch.core.identifiers import BitfieldSpec
    from repro_torch.core.pipeline import tiles as _t
    from repro_torch.core.pipeline.registry import get_backend
    from repro_torch.core.pipeline.spec import make_radix_plan

    be = get_backend(backend)
    if not be.tiled or not be.fuses_digits:
        return None
    if families is None:
        families = be.families
    m2, stage_m = 1 << bits, 1 << split
    dev = search_device(device)
    pair = BitfieldSpec(shift, bits)
    keys, values, _ = synthetic_inputs(n, pair, key_value=key_value, device=dev, seed=seed)
    times, notes = [], {}
    with searching():
        for tile in candidates:
            if tile > max(n, _t._MIN_TILE) or (be.uses_kernels and tile > _t.MAX_TILE):
                continue
            for fam in families:
                if be.uses_kernels:
                    occs = _t.plan_occupancy(tile, pair, method=method, key_value=key_value,
                                             family=fam, pair_bits=bits, device=dev)
                    if not _t._launchable(occs):
                        continue                # no kernel of it can launch
                    notes[tile, fam] = _t._blocks_note(occs)
                for sb in sub_bits_candidates:
                    if not 0 < sb <= min(bits, 8):
                        continue
                    plan = make_radix_plan(n, shift, bits, method=method, key_value=key_value,
                                           backend=backend, tile=tile, family=fam,
                                           digit_split=split, sub_bits=sb)
                    times.append((tile, fam, sb, time_call(lambda p=plan: p(keys, values),
                                                           trials, dev)))
    note_times(times)
    if not times:
        return None
    t_best, tile_b, fam_b, sb_b = min((t, tile, fam, sb) for tile, fam, sb, t in times)
    grid = (f"fused-pair grid tiles={tuple(candidates)} x families={tuple(families)} x "
            f"sub_bits={tuple(sub_bits_candidates)}")
    tkey = _t._tile_key(n, m2, method, key_value, backend, 2, stage_m)
    _t._TILE_CACHE[tkey] = tile_b
    _t._TILE_REASONS[tkey] = (f"autotuned over {grid}: {tile_b} won at {t_best:.3e}s"
                              + (f"; {notes[tile_b, fam_b]}" if (tile_b, fam_b) in notes else ""))
    _t._TILE_CACHE.pop(_t._tile_key(n, m2, method, not key_value, backend, 2, stage_m), None)
    fkey = _t._family_key(n, stage_m, method, backend, 2)
    _t._FAMILY_CACHE[fkey] = (fam_b, f"autotuned over {grid}: ({tile_b}, {fam_b!r}, {sb_b}) "
                                     f"won at {t_best:.3e}s")
    sbkey = (n, m2, method, key_value, backend, stage_m)
    _t._SUB_BITS_CACHE[sbkey] = sb_b
    record("tile", tkey, tile_b, dev)
    record("family", fkey, fam_b, dev)
    record("sub_bits", sbkey, sb_b, dev)
    return tile_b, fam_b, sb_b
