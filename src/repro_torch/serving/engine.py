"""The continuous-batching step engine (counterpart of
``repro/serving/engine.py``, DESIGN.md §16).

One :meth:`ServerLoop.step` = one admission decision + ONE segmented plan
launch for every admitted request:

    queue -> admit (RangeSpec length bucketing) -> pad to a shape class ->
    route_tokens_segmented (ONE segmented positions_only multisplit; on
    ``cuda`` K1s then K3s) -> per-request completion + metrics

Warm-plan reuse is structural, not incidental: admitted batches are padded
to a small ladder of ``(tokens, segments)`` shape classes and the plan
caches of ``repro_torch.ops`` hash by value, so no plan is rebuilt after
the first step of each shape class (counter-tested on the plan caches).
There is no jit: the plan cache is what keeps a step warm.
``REPRO_AUTOTUNE=1`` + :meth:`ServerLoop.prewarm` moves even the
first-miss autotune search out of the serving path.

Steps are pipelined as in the JAX package: step k is launched before step
k-1 is finalized, and a ``torch.cuda.Event`` recorded after each launch is
what :meth:`ServerLoop.flush` waits on, so a failure of an asynchronous
kernel surfaces inside its retry loop. The ops a step calls run inside
``resilience.bypass()``: the loop applies the ladder (retry, requeue, the
reference rung where ``resilience.fallback`` allows it, which on the card
it does not by default, sampled verification) at its flush, as the JAX
package's loop does around its jitted step. ``route_tokens_segmented`` waits on
the card inside each call (it reads counts back to the host), so the
overlap is smaller than in the JAX package.

Robustness reuses the :class:`~repro_torch.runtime.supervisor.FaultInjector`
pattern: a failed launch retries in-step (bounded), then requeues the batch
at the queue head (bounded per request, then counted ``failed``); submit
past the queue bound sheds (counted); :meth:`ServerLoop.drain` flushes the
queue ignoring the batching deadline on shutdown. Request accounting is
conservation-checked: ``dropped_by_bug`` must be zero always.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import resilience as _rz
from repro_torch.serving.admission import AdmissionConfig, AdmissionPolicy
from repro_torch.serving.metrics import ServingMetrics, StepRecord
from repro_torch.serving.request import Request, RequestQueue

log = logging.getLogger("repro_torch.serving")

__all__ = ["ServingConfig", "ServerLoop"]


@dataclasses.dataclass
class _Inflight:
    """One asynchronously launched, not-yet-finalized serving step."""

    batch: List["Request"]
    ids: np.ndarray
    starts: np.ndarray
    idx: int
    depth_at_admit: int
    n_tok: int
    t0: float
    attempts: int
    out: Any                 # device output (None if the launch itself raised)
    err: Optional[Exception]
    done: Optional[torch.cuda.Event] = None   # recorded after the launch


@functools.lru_cache(maxsize=32)
def _routing_op(num_experts: int, capacity: int, backend: str, device: str):
    """The default routing step, shared across ServerLoop instances: a
    second loop with the same (experts, capacity, backend, device) takes the
    same function, whose plans the ops' plan cache already holds."""
    def run(expert_ids, segment_starts):
        from repro_torch.models.moe import route_tokens_segmented

        return route_tokens_segmented(
            expert_ids, segment_starts, num_experts, capacity, backend=backend, device=device,
        )

    return run


def _record(out: Any) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream of the card ``out`` lies on
    (None for an output on the host, which is complete)."""
    dev = next((t.device for t in _rz._tensors(out) if t.device.type == "cuda"), None)
    if dev is None:
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return event


def _default_token_classes(max_batch_tokens: int) -> Tuple[int, ...]:
    """Padded flat-buffer ladder: x4 steps up to the batch-token cap, so a
    lightly loaded step doesn't pay the full-batch buffer and the plan
    cache stays at a handful of shapes."""
    classes = []
    c = min(256, max_batch_tokens)
    while c < max_batch_tokens:
        classes.append(c)
        c *= 4
    classes.append(max_batch_tokens)
    return tuple(classes)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Continuous-batching server configuration (hashable, all-static)."""

    num_experts: int = 8
    capacity: int = 64               # per-(request, expert) dispatch slots
    max_batch_requests: int = 64
    max_batch_tokens: int = 4096
    max_wait: float = 0.02           # flush deadline (s)
    length_splitters: Tuple[int, ...] = (32, 128)
    token_pad_classes: Tuple[int, ...] = ()     # () -> derived ladder
    backend: str = "cuda"
    device: str = "cuda"
    max_step_attempts: int = 3       # in-step launch tries (1 = no retry)
    max_requeues: int = 1            # failed-step requeues before a request fails
    max_queue_depth: int = 4096
    lookahead_batches: int = 4       # admission window, in max-size batches
    verify_sample_rate: float = 1.0  # launch-sampling rate once REPRO_VERIFY
    verify_seed: int = 0             # is armed (DESIGN.md §17)

    def __post_init__(self) -> None:
        if not self.token_pad_classes:
            object.__setattr__(
                self, "token_pad_classes",
                _default_token_classes(self.max_batch_tokens),
            )
        classes = self.token_pad_classes
        if list(classes) != sorted(set(classes)):
            raise ValueError(f"token_pad_classes must ascend, got {classes}")
        if classes[-1] < self.max_batch_tokens:
            raise ValueError(
                f"largest token class {classes[-1]} < max_batch_tokens "
                f"{self.max_batch_tokens}: a full batch has no shape class"
            )
        if self.max_step_attempts < 1:
            raise ValueError("max_step_attempts must be >= 1")
        if self.lookahead_batches < 1:
            raise ValueError("lookahead_batches must be >= 1")
        if list(self.length_splitters) != sorted(set(self.length_splitters)):
            raise ValueError(
                f"length_splitters must be strictly ascending, got "
                f"{self.length_splitters}"
            )
        if not 0.0 <= self.verify_sample_rate <= 1.0:
            raise ValueError(
                f"verify_sample_rate must be in [0, 1], got "
                f"{self.verify_sample_rate}"
            )

    def admission(self) -> AdmissionConfig:
        return AdmissionConfig(
            max_batch_requests=self.max_batch_requests,
            max_batch_tokens=self.max_batch_tokens,
            max_wait=self.max_wait,
            length_splitters=self.length_splitters,
            backend=self.backend,
            lookahead_batches=self.lookahead_batches,
            device=self.device,
        )


class ServerLoop:
    """Request-level continuous batching over the segmented plan layer.

    ``step_fn(expert_ids, segment_starts)`` is the per-step device program
    (default: :func:`~repro_torch.models.moe.route_tokens_segmented` with
    this config's experts/capacity/backend/device); it always sees the
    PADDED shapes, as host numpy arrays. ``fault_injector`` follows the
    :class:`~repro_torch.runtime.supervisor.FaultInjector` protocol (``check(step)``
    raises to simulate a failure); ``clock`` is injectable for deterministic
    tests.
    """

    def __init__(
        self,
        cfg: ServingConfig,
        *,
        step_fn: Optional[Callable[[Any, Any], Any]] = None,
        fault_injector: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.cfg = cfg
        self.clock = clock
        self.queue = RequestQueue(cfg.max_queue_depth)
        self.policy = AdmissionPolicy(cfg.admission())
        self.metrics = ServingMetrics()
        self.faults = fault_injector
        self._default_step = step_fn is None
        self._step_fn = step_fn or _routing_op(cfg.num_experts, cfg.capacity, cfg.backend,
                                               str(cfg.device))
        self._verify_rng = np.random.RandomState(cfg.verify_seed)
        self._step_idx = 0
        self._next_rid = 0
        self._inflight: Optional[_Inflight] = None
        self.completed: List[Tuple[int, float]] = []   # (rid, latency_s)

    # -- shape classes ------------------------------------------------------
    @property
    def _s_pad(self) -> int:
        # +1: the trailing PAD segment that absorbs pad tokens — a full
        # batch must never leak its padding into a real request's counts
        return self.cfg.max_batch_requests + 1

    def _token_class(self, n_tok: int) -> int:
        for c in self.cfg.token_pad_classes:
            if c >= n_tok:
                return c
        return self.cfg.token_pad_classes[-1]

    def _pack(self, batch: List[Request]) -> Tuple[np.ndarray, np.ndarray, int]:
        """Coalesce a batch into the padded flat buffer + segment starts.

        Pad tokens carry expert ``E-1`` and live in the pad segment (rows
        ``>= len(batch)`` of the counts are synthetic and ignored); empty
        requests are zero-length segments — both exercised every step, which
        is why their plan-layer behavior is regression-pinned.
        """
        lengths = [r.length for r in batch]
        n_tok = int(sum(lengths))
        n_pad = self._token_class(n_tok)
        ids = np.full((n_pad,), self.cfg.num_experts - 1, np.int32)
        if n_tok:
            ids[:n_tok] = np.concatenate([r.expert_ids for r in batch])
        starts = np.full((self._s_pad,), n_tok, np.int32)
        starts[0] = 0
        if len(lengths) > 1:
            starts[1:len(lengths)] = np.cumsum(lengths[:-1])
        return ids, starts, n_tok

    # -- ingress -------------------------------------------------------------
    def submit(self, expert_ids, *, arrival: Optional[float] = None,
               rid: Optional[int] = None) -> bool:
        """Enqueue one request; False = load-shed (queue full / oversized)."""
        arrival = self.clock() if arrival is None else arrival
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid, expert_ids, arrival)
        self.metrics.observe_submit(arrival)
        if req.length > self.cfg.max_batch_tokens:
            self.metrics.observe_shed()          # can never fit a batch
            return False
        ok = self.queue.submit(req)
        if not ok:
            self.metrics.observe_shed()
        self.metrics.observe_queue_depth(self.queue.depth)
        return ok

    # -- one serving step ----------------------------------------------------
    def step(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """Admit + launch once (PIPELINED). Returns None when nothing was
        admissible (not ready and not forced), else a launch report.

        The launch is asynchronous: step ``k``'s dispatch happens BEFORE
        step ``k-1`` is blocked on, so admission/packing host work overlaps
        device execution and the device never idles between steps. The
        previous step's completions (and failure handling) are finalized
        here; call :meth:`flush` to finalize the last in-flight step when
        going idle."""
        now = self.clock()
        batch = self.policy.admit(self.queue, now, force=force)
        if not batch:
            self.metrics.observe_empty_step()
            return None
        depth_at_admit = self.queue.depth + self.policy.pending() + len(batch)
        ids, starts, n_tok = self._pack(batch)
        idx = self._step_idx
        self._step_idx += 1
        t0 = self.clock()
        out, launch_err, done = None, None, None
        try:
            out, done = self._launch(ids, starts, idx)     # async dispatch
        except Exception as e:  # noqa: BLE001 — serving boundary
            launch_err = e
            log.warning("step %d attempt 1 failed at launch: %s", idx, e)
        self.flush()             # wait on the PREVIOUS step while this one runs
        self._inflight = _Inflight(batch, ids, starts, idx, depth_at_admit,
                                   n_tok, t0, 1, out, launch_err, done)
        return {"step": idx, "ok": True, "requests": len(batch),
                "tokens": n_tok, "tokens_padded": int(ids.shape[0])}

    def _launch(self, ids, starts, idx: int):
        """Fault-injection check + asynchronous device dispatch: the output
        and the event recorded after it."""
        if self.faults is not None:
            self.faults.check(idx)
        _rz.check_faults(self.cfg.backend)   # dispatch-level injection (§17)
        with _rz.bypass():                   # the ladder is applied at flush
            out = self._step_fn(ids, starts)
        return out, _record(out)

    def _reference_rerun(self, p: "_Inflight"):
        """Re-run one step on the reference backend (the last rung of the
        §17 ladder at the serving boundary) and wait for it."""
        ref_run = _routing_op(self.cfg.num_experts, self.cfg.capacity, "reference",
                              str(self.cfg.device))
        with _rz.bypass():
            out = ref_run(p.ids, p.starts)
        _rz._block(out)
        self.metrics.degradations += 1
        _rz._count("degradations")
        return out

    def _degrade(self, p: "_Inflight", err: Exception):
        """Persistent kernel failures (lowering / resource) never heal by
        requeueing — the step re-runs on the reference backend instead so
        its requests still complete (degraded, counted). Transient faults
        and non-kernel errors keep the requeue path; a custom ``step_fn``
        has no reference twin; ``REPRO_STRICT`` disables all fallback, and
        on the card so does the default of ``resilience.fallback``: the
        step stays on its kernels and requeues."""
        if (not self._default_step or _rz.strict()
                or not _rz.fallback(self.cfg.device)):
            return None
        kerr = _rz.classify(err, backend=self.cfg.backend)
        if not isinstance(kerr, (_rz.KernelLoweringError,
                                 _rz.KernelResourceError)):
            return None
        try:
            out = self._reference_rerun(p)
        except Exception as ref_e:  # noqa: BLE001 — fall back to requeue
            log.warning("step %d reference fallback failed: %s", p.idx, ref_e)
            return None
        _rz._count("backend_demotions")
        _rz._event("serving_degrade", step=p.idx, frm=self.cfg.backend,
                   to="reference", error=type(kerr).__name__)
        log.warning("step %d degraded to reference after %s: %s",
                    p.idx, type(kerr).__name__, err)
        return out

    def _verify_ctx(self, p: "_Inflight") -> _rz.DispatchContext:
        return _rz.DispatchContext(
            spec_name="route_tokens_segmented", shape=(int(p.ids.shape[0]),),
            num_buckets=self.cfg.num_experts, mode="positions",
            layout="segmented", seed=self.cfg.verify_seed,
        )

    def _maybe_verify(self, p: "_Inflight", out):
        """Sampled runtime verification of one routing launch (§17): on a
        mismatch, count it, emit the structured repro report, and return
        the reference re-run so the degraded result is still correct. In
        strict mode, and on the card unless ``resilience.fallback`` allows
        the reference rung, the mismatch is raised instead."""
        if (not self._default_step or _rz.verify_level() <= 0
                or self.cfg.backend == "reference"
                or self._verify_rng.random_sample()
                >= self.cfg.verify_sample_rate):
            return out
        _rz._count("verify_checks")
        try:
            _rz.verify_routing(out, p.ids, p.starts, self.cfg.num_experts,
                               self.cfg.capacity, backend=self.cfg.backend)
            return out
        except _rz.KernelResultError as ve:
            if _rz.strict():
                raise
            self.metrics.verify_mismatches += 1
            _rz._count("verify_mismatches")
            _rz._event("serving_verify_mismatch", step=p.idx,
                       backend=self.cfg.backend, detail=str(ve))
            _rz._emit_report(self._verify_ctx(p), self.cfg.backend, str(ve))
            if not _rz.fallback(self.cfg.device):
                raise
            _rz._count("reference_reruns")
            log.warning("step %d verify mismatch, re-running on reference: %s",
                        p.idx, ve)
            return self._reference_rerun(p)

    def flush(self) -> None:
        """Finalize the in-flight step: wait on its event, retry its launch
        in place on failure (bounded), then record completions or
        requeue/fail its batch."""
        p = self._inflight
        if p is None:
            return
        self._inflight = None
        out, attempts, err, done = p.out, p.attempts, p.err, p.done
        while True:
            if out is None and err is not None:       # last attempt failed
                if attempts >= self.cfg.max_step_attempts:
                    break
                attempts += 1
                self.metrics.retries += 1
            try:
                if out is None:
                    out, done = self._launch(p.ids, p.starts, p.idx)
                if done is not None:
                    done.synchronize()
                err = None
                break
            except Exception as e:  # noqa: BLE001 — serving boundary
                err, out = e, None
                log.warning("step %d attempt %d failed: %s", p.idx, attempts, e)

        if err is not None:
            out = self._degrade(p, err)      # §17: reference rung, not requeue
            if out is not None:
                err = None
        if err is not None:
            # bounded requeue: the batch goes back to the queue HEAD in
            # order; requests over their requeue budget fail (counted).
            kept, dead = [], []
            for r in p.batch:
                r.requeues += 1
                (kept if r.requeues <= self.cfg.max_requeues else dead).append(r)
            # plan back first, then the failed batch AHEAD of it (it is older)
            self.policy.invalidate(self.queue)
            self.queue.requeue_front(kept)
            self.metrics.requeued += len(kept)
            self.metrics.failed += len(dead)
            rec = StepRecord(p.idx, len(p.batch), p.n_tok, p.ids.shape[0],
                             p.depth_at_admit, self.clock() - p.t0,
                             attempts=attempts, ok=False)
            self.metrics.observe_step(rec)
            return

        out = self._maybe_verify(p, out)     # §17: sampled output checking
        done = self.clock()
        for r in p.batch:
            self.metrics.observe_completion(r.arrival, done)
            self.completed.append((r.rid, done - r.arrival))
        rec = StepRecord(p.idx, len(p.batch), p.n_tok, p.ids.shape[0],
                         p.depth_at_admit, done - p.t0, attempts=attempts)
        self.metrics.observe_step(rec)

    # -- lifecycle -----------------------------------------------------------
    def prewarm(self) -> None:
        """Run every shape class once before traffic, so its plans are
        built (and its kernels loaded) here, not under the first
        user-visible step; when autotuning is armed (``REPRO_AUTOTUNE=1`` /
        ``repro_torch.ops.set_autotune(True)``) that run is where the
        measured (tile, family) search happens."""
        starts = np.zeros((self._s_pad,), np.int32)
        for c in self.cfg.token_pad_classes:
            with _rz.bypass():
                _rz._block(self._step_fn(np.zeros((c,), np.int32), starts))
        # the admission-side length-bucketing op, over the queue-depth
        # padding ladder (powers of two) up to the admission window, so a
        # depth class first seen under traffic doesn't build its plan mid-step
        window = self.cfg.lookahead_batches * self.cfg.max_batch_requests
        depth, probes = 8, []
        while depth <= min(self.cfg.max_queue_depth, window):
            probes.append(depth)
            depth *= 2
        for d in probes:
            dummy = [Request(-1, np.zeros((1,), np.int32), 0.0)] * d
            self.policy.length_groups(dummy)
        log.info("prewarmed %d shape classes, %d admission depths",
                 len(self.cfg.token_pad_classes), len(probes))

    def drain(self) -> Dict[str, float]:
        """Graceful shutdown: flush the queue ignoring the batching deadline
        (bounded — failing requests exhaust their requeue budget and are
        counted), finalize the last in-flight step, then return the final
        metrics summary."""
        while True:
            while self.queue.depth or self.policy.pending():
                self.step(force=True)
            self.flush()          # may requeue a failed in-flight batch
            if not (self.queue.depth or self.policy.pending()):
                return self.metrics_summary()

    # -- observability -------------------------------------------------------
    def metrics_summary(self) -> Dict[str, float]:
        """The exported metrics dict (+ live queue depth and the
        conservation check — ``dropped_by_bug`` MUST be 0)."""
        s = self.metrics.summary()
        queued = self.queue.depth + self.policy.pending()
        if self._inflight is not None:
            queued += len(self._inflight.batch)
        s["queued"] = queued
        s["dropped_by_bug"] = self.metrics.dropped_by_bug(queued)
        return s
