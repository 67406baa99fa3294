"""Graceful degradation and runtime verification for kernel dispatch
(counterpart of ``repro/runtime/resilience.py``, DESIGN.md §17).

The safety net between the plan layer and its callers, on the card:

* **Failure taxonomy.** :func:`classify` wraps what a dispatch raises into
  :class:`KernelLoweringError` (persistent: the kernel cannot be built or
  loaded, or has no image for this card), :class:`KernelResourceError`
  (persistent but tile-shrinkable: device memory, launch resources, or the
  dynamic shared memory a launcher asked for), a *transient*
  :class:`TransientDispatchError` (worth retrying in place), or
  :class:`KernelContextError`: a sticky CUDA error (an illegal address, a
  failed launch) that leaves the process's CUDA context dead, so that every
  later call on the card fails. Programming errors (``ValueError`` /
  ``TypeError`` from argument checks) classify as ``None`` and always
  propagate untouched. The port's surfaces are types and codes, not only
  text: ``torch.OutOfMemoryError``, :class:`~repro_torch.kernels.build.
  KernelBuildError` (a failed ``nvcc`` build, a missing ``nvcc``, a library
  that does not load) and :class:`~repro_torch.kernels.build.
  KernelLaunchError`, whose CUDA error code (and shared-memory flag) is
  read, never its text. The JAX package's text markers are kept for
  everything else, injected faults among them.
* **Degradation ladder.** :func:`dispatch` runs one operation with bounded
  fallback: transient errors retry in place; a resource error first halves
  the tile (down to ``_MIN_TILE``, pinning the survivor); persistent errors
  demote the backend along :data:`DEMOTION_ORDER` (``cuda -> vmap ->
  reference``; the port has no interpret rung). The reference oracle is the
  floor. A context-fatal error strikes the breaker of the rung that raised
  it, quarantines it at the threshold, and re-raises at once: demoting onto
  the dead context would strike ``vmap`` with a fault that is not its own
  and fail on ``reference`` anyway. ``REPRO_STRICT=1`` / :func:`set_strict`
  disables all fallback.
* **On the card the ladder stays on the kernels** unless the caller opts in
  (:func:`set_fallback` / ``REPRO_FALLBACK=1``): a dispatch whose tensors lie
  on a CUDA device retries in place and shrinks its tile, and otherwise
  re-raises. It neither demotes to the plain versions (``vmap``,
  ``reference``) nor reads or writes the quarantine, so one out-of-memory
  never sends a shape to plain PyTorch in this process or a later one. A
  verification mismatch there is reported and raised. This departs from the
  JAX package, whose ladder demotes by default; on the CPU it demotes by
  default, as there.
* **Circuit breaker.** Per ``(spec, shape, backend)`` plan class, repeated
  persistent failures (:data:`BREAKER_THRESHOLD`) quarantine the class in a
  JSON sidecar beside the autotune file (its own file,
  ``multisplit_resilience_torch.json``; atomic write, lazy load, a corrupt
  or stale file loads as empty, an unwritable directory keeps the
  quarantine in memory). Keys carry ``autotune.host_fingerprint`` of the
  dispatch's device, so a quarantine learned on a card never applies to the
  CPU, nor the reverse. ``clear_tile_cache()`` drops the loaded snapshot (the
  quarantine survives, as for a fresh process); ``clear_tile_cache(disk=True)``
  deletes the file.
* **Runtime verification.** :func:`set_verify` / ``REPRO_VERIFY``: level 1
  checks counts conservation and offset monotonicity (O(m) a row); level 2
  holds the output against a stable ``torch.sort`` of the combined (row,
  label) key, as the port's oracles do: the permutation, the keys and the
  values, compared as integer bit patterns on the result's device. On a
  mismatch the op re-runs on ``reference``, a repro report is kept, and the
  breaker is struck.
* **Fault injection.** :func:`set_fault_injector` arms a
  :class:`~repro_torch.runtime.supervisor.FaultInjector` at the dispatch
  site, so the whole ladder runs without a faulty card.

Everything here is host-side and eager. The ops bypass the ladder for
functorch-wrapped inputs (under ``torch.vmap`` or ``torch.func.grad``), so
the transform rules see the plain op, and inside :func:`bypass`, which the
serving loop takes around its launches: it applies the ladder at its own
flush, as the JAX package's serving loop does around its jitted steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import tempfile
import threading
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.pipeline import tiles as _tiles
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError

log = logging.getLogger("repro_torch.resilience")

SCHEMA_VERSION = 1
QUARANTINE_FILE = "multisplit_resilience_torch.json"

# The fallback chain, best first. Backends outside the chain demote straight
# to the oracle.
DEMOTION_ORDER = ("cuda", "vmap", "reference")

# Persistent failures per plan class before the breaker trips and the class
# is quarantined on disk.
BREAKER_THRESHOLD = 3

# In-place retries per rung for transient failures before demoting anyway.
MAX_TRANSIENT_RETRIES = 2

_ENV_STRICT = "REPRO_STRICT"
_ENV_VERIFY = "REPRO_VERIFY"

_TRUE = ("1", "true", "yes", "on")


# ---------------------------------------------------------------------------
# Failure taxonomy
# ---------------------------------------------------------------------------

class KernelDispatchError(RuntimeError):
    """A classified kernel-dispatch failure wrapping the raw exception.

    ``transient`` marks failures worth retrying in place; persistent
    failures go to tile-shrink or demotion. ``original`` is the exception
    as raised; ``backend`` / ``plan_class`` locate the failure."""

    transient = False

    def __init__(self, message: str, *, original: Optional[BaseException] = None,
                 backend: Optional[str] = None, plan_class: Optional[Tuple] = None):
        super().__init__(message)
        self.original = original
        self.backend = backend
        self.plan_class = plan_class
        self.__cause__ = original


class KernelLoweringError(KernelDispatchError):
    """The kernel cannot run here: ``nvcc`` is missing or refused the
    source, its library does not load, or the library has no image for this
    card. Persistent: retrying cannot succeed."""


class KernelResourceError(KernelDispatchError):
    """Resource exhaustion: device memory, launch resources, or the dynamic
    shared memory a launcher asked for. Persistent for THIS tile, but the
    working set scales with the tile: halve and retry first."""


class KernelResultError(KernelDispatchError):
    """The kernel ran but gave a wrong answer (a verification mismatch):
    recover through the oracle."""


class TransientDispatchError(KernelDispatchError):
    """An environmental failure worth a bounded in-place retry."""

    transient = True


class KernelContextError(KernelDispatchError):
    """A sticky CUDA error (illegal address, failed launch, misaligned
    address, illegal instruction, hardware stack error): the process's CUDA
    context is dead and every later call on the card fails. The ladder
    strikes the rung that raised it and re-raises at once."""


# Marker -> class tables of the JAX package, for exception text; the
# injected faults carry the same markers so the chaos runs exercise the
# real classifier.
_RESOURCE_MARKERS = (
    "resource_exhausted", "out of memory", "oom", "vmem", "smem",
    "scratch limit", "allocat",
)
_LOWERING_MARKERS = (
    "mosaic", "lowering", "unsupported", "not implemented", "unimplemented",
    "internal: failed to compile", "does not lower",
    "nvcc", "no kernel image", "invalid device function",
)
_TRANSIENT_MARKERS = (
    "deadline_exceeded", "unavailable", "aborted", "cancelled", "preempt",
    "connection reset", "transient",
)
# torch's text of the sticky CUDA errors ("CUDA error: an illegal memory
# access was encountered", ...)
_CONTEXT_MARKERS = (
    "illegal memory access", "misaligned address", "illegal instruction",
    "unspecified launch failure", "hardware stack error",
)

# CUDA error codes (cudaError): the launch result, not text, decides.
_CONTEXT_CODES = frozenset((700, 714, 715, 716, 719))
_RESOURCE_CODES = frozenset((2, 701))
_LOWERING_CODES = frozenset((98, 209))


def _marked(msg: str, markers: Tuple[str, ...]) -> bool:
    # left word boundary only: "oom" must not match "boom", but "allocat"
    # must still match "allocating"/"allocation"
    return any(re.search(r"(?<![a-z0-9])" + re.escape(m), msg) for m in markers)


def _launch_class(exc: KernelLaunchError):
    """The class of a failed launch, from its CUDA error code, then its
    flag: a kernel with no image for the card fails its shared-memory set-up
    too, and stays a lowering fault."""
    if exc.code in _CONTEXT_CODES:
        return KernelContextError
    if exc.code in _LOWERING_CODES:
        return KernelLoweringError
    if exc.smem_refused or exc.code in _RESOURCE_CODES:
        return KernelResourceError
    return KernelDispatchError


def classify(exc: BaseException, *, backend: Optional[str] = None,
             plan_class: Optional[Tuple] = None) -> Optional[KernelDispatchError]:
    """Wrap a raw dispatch exception into the taxonomy, or return ``None``
    for exceptions the ladder must NOT handle (``ValueError`` /
    ``TypeError`` from our own argument checks propagate untouched, on
    every rung)."""
    if isinstance(exc, KernelDispatchError):
        return exc
    msg = f"{type(exc).__name__}: {exc}".lower()
    kw: Dict[str, Any] = dict(original=exc, backend=backend, plan_class=plan_class)
    text = f"[{backend}] {exc}"
    if isinstance(exc, KernelLaunchError):
        return _launch_class(exc)(text, **kw)
    if isinstance(exc, KernelBuildError):
        return KernelLoweringError(text, **kw)
    if isinstance(exc, torch.OutOfMemoryError):
        return KernelResourceError(text, **kw)
    if _marked(msg, _CONTEXT_MARKERS):
        return KernelContextError(text, **kw)
    if isinstance(exc, (ValueError, TypeError)) and not _marked(
            msg, _RESOURCE_MARKERS + _LOWERING_MARKERS):
        return None
    if isinstance(exc, MemoryError) or _marked(msg, _RESOURCE_MARKERS):
        return KernelResourceError(text, **kw)
    if isinstance(exc, NotImplementedError) or _marked(msg, _LOWERING_MARKERS):
        return KernelLoweringError(text, **kw)
    if _marked(msg, _TRANSIENT_MARKERS):
        return TransientDispatchError(text, **kw)
    # Unknown runtime failure: a persistent dispatch error — the ladder
    # degrades it, the breaker learns it, strict mode re-raises it.
    if isinstance(exc, (RuntimeError, OSError)):
        return KernelDispatchError(text, **kw)
    return None


# ---------------------------------------------------------------------------
# Configuration: strict + fallback + verify (env-resolved, override via setters)
# ---------------------------------------------------------------------------

_ENV_FALLBACK = "REPRO_FALLBACK"

_STRICT_OVERRIDE: Optional[bool] = None
_FALLBACK_OVERRIDE: Optional[bool] = None
_VERIFY_OVERRIDE: Optional[int] = None


def set_strict(enabled: Optional[bool]) -> None:
    """Disable (``True``) all fallback: no ladder, no quarantine skip, no
    verify recovery — the original exception propagates. ``None`` defers
    back to the ``REPRO_STRICT`` environment variable."""
    global _STRICT_OVERRIDE
    _STRICT_OVERRIDE = None if enabled is None else bool(enabled)


def strict() -> bool:
    if _STRICT_OVERRIDE is not None:
        return _STRICT_OVERRIDE
    return os.environ.get(_ENV_STRICT, "").strip().lower() in _TRUE


def set_fallback(enabled: Optional[bool]) -> None:
    """Let (``True``) a dispatch on the card leave its kernels: demote to
    the plain versions and quarantine a failing plan class, as the JAX
    package's ladder does. ``False`` keeps every dispatch on its backend
    (retries and tile shrinks only). ``None`` defers back to
    ``REPRO_FALLBACK``, and without it to the default: off for tensors on a
    CUDA device, on for the CPU."""
    global _FALLBACK_OVERRIDE
    _FALLBACK_OVERRIDE = None if enabled is None else bool(enabled)


def fallback(device=None) -> bool:
    """Whether a dispatch on ``device`` may demote and quarantine."""
    if _FALLBACK_OVERRIDE is not None:
        return _FALLBACK_OVERRIDE
    raw = os.environ.get(_ENV_FALLBACK, "").strip().lower()
    if raw:
        return raw in _TRUE
    return device is None or torch.device(device).type != "cuda"


def set_verify(level: Optional[int]) -> None:
    """Arm runtime output verification: 0 off, 1 = counts conservation and
    offset monotonicity, 2 = the output against a stable sort (DESIGN.md
    §17). ``None`` defers back to ``REPRO_VERIFY``."""
    global _VERIFY_OVERRIDE
    if level is None:
        _VERIFY_OVERRIDE = None
        return
    level = int(level)
    if not 0 <= level <= 2:
        raise ValueError(f"verify level must be 0, 1 or 2, got {level}")
    _VERIFY_OVERRIDE = level


def verify_level() -> int:
    if _VERIFY_OVERRIDE is not None:
        return _VERIFY_OVERRIDE
    raw = os.environ.get(_ENV_VERIFY, "").strip()
    if not raw:
        return 0
    try:
        return max(0, min(2, int(raw)))
    except ValueError:
        return 1 if raw.lower() in _TRUE else 0


# ---------------------------------------------------------------------------
# Counters, events, repro reports
# ---------------------------------------------------------------------------

_COUNTER_KEYS = (
    "degradations", "tile_shrinks", "backend_demotions", "transient_retries",
    "quarantine_skips", "breaker_trips", "verify_checks", "verify_mismatches",
    "reference_reruns",
)
_STATS: Dict[str, int] = {k: 0 for k in _COUNTER_KEYS}
_EVENTS: deque = deque(maxlen=256)
_REPORTS: deque = deque(maxlen=32)
_LOCK = threading.Lock()


def stats() -> Dict[str, int]:
    """Snapshot of the degradation/verification counters since process
    start (or :func:`reset_stats`)."""
    with _LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _LOCK:
        for k in _COUNTER_KEYS:
            _STATS[k] = 0
        _EVENTS.clear()
        _REPORTS.clear()


def _count(key: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[key] += n


def _event(kind: str, **fields) -> None:
    with _LOCK:
        _EVENTS.append({"kind": kind, **fields})


def events() -> Tuple[Dict[str, Any], ...]:
    """The last <= 256 degradation events."""
    with _LOCK:
        return tuple(dict(e) for e in _EVENTS)


def reports() -> Tuple[Dict[str, Any], ...]:
    """The last <= 32 structured verify-mismatch repro reports."""
    with _LOCK:
        return tuple(dict(r) for r in _REPORTS)


def last_report() -> Optional[Dict[str, Any]]:
    with _LOCK:
        return dict(_REPORTS[-1]) if _REPORTS else None


def _emit_report(ctx: "DispatchContext", backend: str, detail: str) -> Dict[str, Any]:
    """The minimal structured repro report of one verify mismatch: enough to
    rebuild the failing plan (spec, shape, backend, seed), nothing
    process-local."""
    report = {
        "spec": ctx.spec_name,
        "shape": ctx.shape,
        "num_buckets": ctx.num_buckets,
        "method": ctx.method,
        "key_value": ctx.key_value,
        "mode": ctx.mode,
        "layout": ctx.layout,
        "backend": backend,
        "seed": ctx.seed,
        "detail": detail,
    }
    with _LOCK:
        _REPORTS.append(report)
    log.error("verify mismatch: %s", json.dumps(report, sort_keys=True, default=str))
    return report


# ---------------------------------------------------------------------------
# Circuit breaker + persistent quarantine (the autotune-cache discipline)
# ---------------------------------------------------------------------------

_BREAKER: Dict[str, int] = {}        # class key -> persistent-failure strikes
_QUAR_MEM: Dict[str, str] = {}       # class key -> reason (process-local view)
_QUAR_LOADED: Optional[Dict[str, str]] = None   # lazy disk snapshot


def quarantine_path():
    """The sidecar lives beside the autotune file (the same
    ``REPRO_AUTOTUNE_DIR`` / ``set_autotune(cache_dir=...)`` override), in
    its OWN file: clearing tuning facts must not clear failure facts."""
    from repro_torch.core.pipeline import autotune as _at

    return _at.cache_path().parent / QUARANTINE_FILE


def _q_entries() -> Dict[str, str]:
    """Lazily loaded disk snapshot; a missing, corrupt or old-schema file
    loads as empty."""
    global _QUAR_LOADED
    if _QUAR_LOADED is None:
        _QUAR_LOADED = {}
        try:
            with open(quarantine_path()) as f:
                raw = json.load(f)
            if (isinstance(raw, dict) and raw.get("version") == SCHEMA_VERSION
                    and isinstance(raw.get("entries"), dict)):
                _QUAR_LOADED = {str(k): str(v) for k, v in raw["entries"].items()}
        except (OSError, ValueError):
            pass
    return _QUAR_LOADED


def _q_flush(entries: Dict[str, str]) -> None:
    """Write the file whole (a temporary file, then ``os.replace``); a
    directory that cannot be written keeps the quarantine in memory."""
    path = quarantine_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".resilience-")
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


def class_key(plan_class: Tuple, backend: str, device=None) -> str:
    """fingerprint | quarantine | plan-class parts | backend: the autotune
    file's key discipline, with the fingerprint of ``device`` (the
    dispatch's; the current card, else the CPU, when None), so a quarantine
    is a fact of the machine and its card."""
    from repro_torch.core.pipeline import autotune as _at

    parts = "|".join(str(x) for x in plan_class)
    return f"{_at.host_fingerprint(device)}|quarantine|{parts}|{backend}"


def quarantine(key: str, reason: str) -> None:
    """Quarantine one (plan class, backend): in memory AND on disk."""
    global _QUAR_LOADED
    _QUAR_MEM[key] = reason
    ent = dict(_q_entries())
    ent[key] = reason
    _q_flush(ent)
    _QUAR_LOADED = ent


def is_quarantined(key: str) -> Optional[str]:
    """The quarantine reason for a class key, or None: the process-local
    view first, then the (lazily loaded) disk snapshot."""
    hit = _QUAR_MEM.get(key)
    if hit is not None:
        return hit
    return _q_entries().get(key)


def record_failure(key: str, err: KernelDispatchError) -> bool:
    """One persistent-failure strike against a plan class; trips the
    breaker (and quarantines) at :data:`BREAKER_THRESHOLD`. Returns True
    when this strike tripped it."""
    strikes = _BREAKER.get(key, 0) + 1
    _BREAKER[key] = strikes
    if strikes >= BREAKER_THRESHOLD and key not in _QUAR_MEM:
        reason = f"{type(err).__name__} x{strikes}: {err}"
        quarantine(key, reason)
        _count("breaker_trips")
        _event("breaker_trip", key=key, reason=reason)
        log.warning("circuit breaker tripped: %s", reason)
        return True
    return False


def breaker_strikes() -> Dict[str, int]:
    return dict(_BREAKER)


def quarantine_snapshot() -> Dict[str, str]:
    """Every quarantined class visible right now (memory and disk)."""
    merged = dict(_q_entries())
    merged.update(_QUAR_MEM)
    return merged


def drop_loaded() -> None:
    """Forget the in-process quarantine view; the next check reads the
    file again (what a fresh process would see), so the quarantine survives
    the reload."""
    clear_quarantine(disk=False)


def clear_quarantine(disk: bool = False) -> None:
    """Drop the quarantine's in-process view (the file survives, as for a
    fresh process); ``disk=True`` deletes the file too. It is the hook of
    ``clear_tile_cache(disk)``: the pipeline layer reaches the quarantine
    only so."""
    global _QUAR_LOADED
    _QUAR_MEM.clear()
    _BREAKER.clear()
    if disk:
        _QUAR_LOADED = {}
        try:
            os.remove(quarantine_path())
        except OSError:
            pass
    else:
        _QUAR_LOADED = None


_tiles.on_clear(clear_quarantine)


# ---------------------------------------------------------------------------
# Dispatch-level fault injection (exercising the ladder without a faulty card)
# ---------------------------------------------------------------------------

_FAULT_INJECTOR: Optional[Any] = None


def set_fault_injector(injector: Optional[Any]) -> None:
    """Arm a :class:`~repro_torch.runtime.supervisor.FaultInjector`
    (anything with ``check_dispatch(backend)``) at the dispatch site;
    ``None`` disarms. Injected exceptions carry classifiable messages, so
    the real classifier routes them down the ladder."""
    global _FAULT_INJECTOR
    _FAULT_INJECTOR = injector


def fault_injector() -> Optional[Any]:
    return _FAULT_INJECTOR


def check_faults(backend: str) -> None:
    """The injection site: called once per dispatch attempt (ops AND the
    serving launch) with the attempt's backend."""
    if _FAULT_INJECTOR is not None:
        _FAULT_INJECTOR.check_dispatch(backend)


# ---------------------------------------------------------------------------
# The degradation ladder
# ---------------------------------------------------------------------------

_BYPASS = threading.local()


@contextlib.contextmanager
def bypass():
    """Run the ops called inside without the ladder (no fault check, no
    retry, no verification): for a caller that applies the ladder at its own
    boundary, as the serving loop does at its flush. The JAX package's ops
    are bypassed inside a jit trace, where the serving steps run."""
    depth = getattr(_BYPASS, "depth", 0)
    _BYPASS.depth = depth + 1
    try:
        yield
    finally:
        _BYPASS.depth = depth


def bypassed() -> bool:
    """True inside :func:`bypass` (on this thread)."""
    return getattr(_BYPASS, "depth", 0) > 0


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """The plan-class identity of one dispatch: what the breaker keys on and
    the repro report serializes. ``spec_name`` is the bucket spec's stable
    name, ``shape`` the input key shape; ``device`` (not part of the plan
    class) picks the fingerprint of the quarantine key."""

    spec_name: str
    shape: Tuple[int, ...]
    num_buckets: int
    method: str = "bms"
    key_value: bool = False
    mode: str = "reorder"
    layout: str = "flat"            # flat | batched | segmented
    seed: Optional[int] = None
    device: Optional[str] = None

    def plan_class(self) -> Tuple:
        return (self.spec_name, self.shape, self.num_buckets, self.method,
                self.key_value, self.mode, self.layout)


def demote(backend: str) -> Optional[str]:
    """The next rung down, or None at (or below) the reference floor."""
    if backend == "reference":
        return None
    try:
        i = DEMOTION_ORDER.index(backend)
    except ValueError:
        return "reference"          # unknown backend: fall to the oracle
    return DEMOTION_ORDER[i + 1]


def _tensors(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)


def _block(result: Any) -> Any:
    """Wait for the card where the result lies, so that a failure of an
    asynchronous kernel surfaces inside the ladder's ``try``."""
    for dev in {t.device for t in _tensors(result) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return result


def dispatch(
    run: Callable[[str, Optional[int]], Any],
    ctx: DispatchContext,
    *,
    backend: str,
    tile: Optional[int] = None,
    resolved_tile: Optional[Callable[[str], int]] = None,
    pin_tile: Optional[Callable[[str, int], None]] = None,
    verifier: Optional[Callable[[Any, str], None]] = None,
) -> Any:
    """Execute ``run(backend, tile)`` under the degradation ladder.

    ``run`` must be re-invocable with any (backend, tile) pair;
    ``resolved_tile(backend)`` reports the tile the plan would resolve (the
    halve-and-retry starting point); ``pin_tile(backend, tile)`` pins a
    shrink survivor; ``verifier(result, backend)`` raises
    :class:`KernelResultError` on an output-invariant violation (skipped on
    the reference rung: the oracle defines correctness).

    Strict mode runs the requested config once, verifying if armed, and
    re-raises everything. Otherwise: quarantined rungs are skipped,
    transient failures retry in place, resource failures halve the tile to
    ``_MIN_TILE`` then demote, other persistent failures demote, verify
    mismatches recover through one reference re-run, and a context-fatal
    error strikes its rung and re-raises. A failure on the reference rung
    itself propagates. Without :func:`fallback` for ``ctx.device`` (the
    default on the card) only the retries and the tile shrinks remain:
    the quarantine is neither read nor written, and what would demote or
    re-run on ``reference`` re-raises instead.
    """
    level = verify_level()
    if strict():
        check_faults(backend)
        result = run(backend, tile)
        if verifier is not None and level > 0 and backend != "reference":
            _count("verify_checks")
            verifier(_block(result), backend)
        return result

    may_leave = fallback(ctx.device)
    b, t = backend, tile
    transient_left = MAX_TRANSIENT_RETRIES
    shrunk = False
    degraded = False
    while True:
        key = class_key(ctx.plan_class(), b, ctx.device) if may_leave else None
        if key is not None and b != "reference" and is_quarantined(key):
            _count("quarantine_skips")
            _event("quarantine_skip", key=key, backend=b)
            nb = demote(b)
            _count("backend_demotions")
            _count("degradations")
            b, t, shrunk = nb, None, False
            transient_left = MAX_TRANSIENT_RETRIES
            degraded = True
            continue
        try:
            check_faults(b)
            result = run(b, t)
            # wait inside the try whenever a failure is plausible or must be
            # caught here: verification armed, faults armed, or degraded once
            if degraded or level > 0 or _FAULT_INJECTOR is not None:
                _block(result)
            if verifier is not None and level > 0 and b != "reference":
                _count("verify_checks")
                verifier(result, b)
            if shrunk and t is not None and pin_tile is not None:
                pin_tile(b, t)
            return result
        except Exception as exc:  # noqa: BLE001 — the resilience boundary
            err = classify(exc, backend=b, plan_class=ctx.plan_class())
            if err is None or b == "reference":
                raise
            if isinstance(err, KernelContextError):
                if may_leave:
                    record_failure(key, err)
                log.error("context-fatal CUDA error on %r, not demoting: %s", b, err)
                raise
            if isinstance(err, KernelResultError):
                _count("verify_mismatches")
                _emit_report(ctx, b, str(err))
                if not may_leave:
                    raise
                record_failure(key, err)
                _count("reference_reruns")
                _count("degradations")
                _event("verify_fallback", backend=b, spec=ctx.spec_name,
                       shape=ctx.shape, detail=str(err))
                log.warning("verify mismatch on %r; recovering via reference", b)
                return _block(run("reference", None))
            if err.transient and transient_left > 0:
                transient_left -= 1
                _count("transient_retries")
                log.info("transient dispatch failure on %r, retrying: %s", b, err)
                degraded = True
                continue
            if may_leave:
                record_failure(key, err)
            if isinstance(err, KernelResourceError):
                base = t if t is not None else (
                    resolved_tile(b) if resolved_tile is not None else None)
                if base is not None and base // 2 >= _tiles._MIN_TILE:
                    t = base // 2
                    shrunk = True
                    degraded = True
                    _count("tile_shrinks")
                    _count("degradations")
                    _event("tile_shrink", backend=b, tile=t, spec=ctx.spec_name,
                           shape=ctx.shape)
                    log.warning("resource failure on %r; retrying tile=%d", b, t)
                    continue
            nb = demote(b) if may_leave else None
            if nb is None:
                raise
            _count("backend_demotions")
            _count("degradations")
            _event("backend_demotion", frm=b, to=nb, spec=ctx.spec_name,
                   shape=ctx.shape, error=type(err).__name__)
            log.warning("demoting backend %r -> %r after %s: %s",
                        b, nb, type(err).__name__, err)
            b, t, shrunk = nb, None, False
            transient_left = MAX_TRANSIENT_RETRIES
            degraded = True


# ---------------------------------------------------------------------------
# Runtime verification (the level-1/level-2 invariants)
# ---------------------------------------------------------------------------

def _fail(detail: str, backend: Optional[str], ctx: Optional[DispatchContext]):
    raise KernelResultError(
        f"[{backend}] output verification failed: {detail}",
        backend=backend,
        plan_class=None if ctx is None else ctx.plan_class(),
    )


_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The tensor's elements as integer bit patterns of their width (NaN
    payloads and -0.0 compare exactly)."""
    if x.dtype == torch.bool:
        return x
    return x.view(_INT_OF_WIDTH[x.element_size()])


def _rows(n_rows: int, row_len: torch.Tensor, device) -> torch.Tensor:
    """The row id of every element of rows of ``row_len`` elements."""
    return torch.repeat_interleave(torch.arange(n_rows, device=device), row_len)


def verify_result(
    result: Any,
    *,
    keys: Any,
    spec: Any,
    n: int,
    values: Any = None,
    segment_starts: Any = None,
    mode: str = "reorder",
    level: Optional[int] = None,
    backend: Optional[str] = None,
    ctx: Optional[DispatchContext] = None,
) -> None:
    """Check a :class:`~repro_torch.core.pipeline.stages.MultisplitResult`
    against the paper's invariants, on the result's device.

    Level 1: every counts row sums to its row's element count and
    ``bucket_starts`` is the exclusive cumsum of counts (hence monotone).
    Level 2 also holds the permutation (a valid, row- or segment-local
    permutation first, then the stable bucket order), the output keys and
    the values against one stable ``torch.sort`` of the combined (row,
    label) key. Raises :class:`KernelResultError` on the first violated
    invariant."""
    level = verify_level() if level is None else level
    if level <= 0:
        return
    counts = torch.as_tensor(result.bucket_counts)
    dev = counts.device
    starts = torch.as_tensor(result.bucket_starts).to(dev)
    seg = None if segment_starts is None else torch.as_tensor(segment_starts).to(
        device=dev, dtype=torch.int64)

    # ---- level 1: conservation + monotonicity (O(m) a row) ----
    if bool((counts < 0).any()):
        _fail(f"negative bucket counts: min={int(counts.min())}", backend, ctx)
    if counts.dim() == 1:                      # flat
        if int(counts.sum()) != n:
            _fail(f"counts conservation: sum={int(counts.sum())} != n={n}", backend, ctx)
        row_len = torch.tensor([n], device=dev)
    elif seg is not None:                      # segmented: rows are segments
        row_len = torch.diff(seg, append=torch.tensor([n], device=dev))
        row_sums = counts.sum(dim=1)
        if not torch.equal(row_sums, row_len.to(row_sums.dtype)):
            _fail(f"segment counts conservation: row sums {row_sums.tolist()} "
                  f"!= segment lengths {row_len.tolist()}", backend, ctx)
    else:                                      # batched: every row is one n
        row_len = torch.full((counts.shape[0],), n, device=dev)
        if not bool((counts.sum(dim=1) == n).all()):
            _fail(f"batched counts conservation: row sums "
                  f"{counts.sum(dim=1).tolist()} != n={n}", backend, ctx)
    expect_starts = torch.cumsum(counts, dim=-1, dtype=counts.dtype) - counts
    if not torch.equal(starts, expect_starts):
        _fail("bucket_starts is not the exclusive cumsum of counts "
              "(offset monotonicity violated)", backend, ctx)
    if level == 1 or mode == "counts_only":
        return

    # ---- level 2: the stable bucket order, from one stable sort ----
    keys_in = torch.as_tensor(keys).to(dev).reshape(-1)
    total = keys_in.shape[0]
    m = spec.num_buckets
    row = _rows(row_len.shape[0], row_len, dev)
    row_base = (torch.cumsum(row_len, 0) - row_len)[row]
    labels = spec.emit(keys_in).to(dev).long().clamp(0, m - 1)
    order = torch.sort(row * m + labels, stable=True).indices
    dest = torch.empty(total, dtype=torch.int64, device=dev)
    dest[order] = torch.arange(total, device=dev)
    if result.permutation is not None:
        perm = torch.as_tensor(result.permutation).to(dev).reshape(-1).long()
        local = ("segment-local" if seg is not None else
                 "row-local" if counts.dim() > 1 else "")
        in_row = (perm >= 0) & (perm < row_len[row])
        if not bool(in_row.all()) or not bool(
                (torch.bincount(perm + row_base, minlength=total) == 1).all()):
            _fail(f"permutation is not a {local + ' ' if local else ''}permutation of "
                  f"arange(n)", backend, ctx)
        if not torch.equal(perm + row_base, dest):
            _fail("permutation is not the stable bucket order of the input",
                  backend, ctx)
    if mode != "reorder" or result.keys is None:
        return
    keys_out = torch.as_tensor(result.keys).to(dev).reshape(-1)
    if not torch.equal(_bits(keys_out), _bits(keys_in)[order]):
        _fail("output keys are not the input in stable bucket order (not a permutation "
              "of the input, or bucket ids out of order)", backend, ctx)
    if values is not None and result.values is not None:
        vals_in = torch.as_tensor(values).to(dev).reshape(-1)
        vals_out = torch.as_tensor(result.values).to(dev).reshape(-1)
        if not torch.equal(_bits(vals_out), _bits(vals_in)[order]):
            _fail("values were not carried by the key permutation", backend, ctx)


def verify_routing(out: Any, ids: Any, starts: Any, num_experts: int, capacity: int, *,
                   level: Optional[int] = None, backend: Optional[str] = None) -> None:
    """The serving-step variant: check one ``route_tokens_segmented`` output
    ``(slot, keep, counts)`` on its device. Level 1: per-request expert
    loads conserve every token. Level 2: kept slots are unique, in range,
    and each (request, expert) keeps exactly ``min(load, capacity)`` tokens.
    Raises :class:`KernelResultError`."""
    level = verify_level() if level is None else level
    if level <= 0:
        return
    slot, keep, counts = (torch.as_tensor(x) for x in out)
    n = int(torch.as_tensor(ids).shape[0])
    if bool((counts < 0).any()):
        _fail(f"negative routing counts: min={int(counts.min())}", backend, None)
    if int(counts.sum()) != n:
        _fail(f"routing counts conservation: sum={int(counts.sum())} != tokens={n}",
              backend, None)
    if level == 1:
        return
    s = counts.shape[0]
    kept = slot.to(counts.device)[keep.to(device=counts.device, dtype=torch.bool)].long()
    if kept.numel() and (int(kept.min()) < 0 or int(kept.max()) >= s * num_experts * capacity):
        _fail("kept dispatch slot out of range", backend, None)
    if kept.numel() and int(torch.bincount(kept).max()) > 1:
        _fail("kept dispatch slots collide", backend, None)
    expect_kept = int(counts.clamp(max=capacity).sum())
    if kept.numel() != expect_kept:
        _fail(f"kept token count {kept.numel()} != sum(min(load, capacity))={expect_kept}",
              backend, None)
