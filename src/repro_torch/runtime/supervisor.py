"""Training-loop supervisor: checkpoint/restart, failure retry, elastic
re-mesh, straggler detection; and the seeded fault injector (counterpart
of ``repro/runtime/supervisor.py``).

Fault-tolerance model, the JAX package's:

* **Checkpoint/restart**: async checkpoints every ``checkpoint_every``
  steps; on a step that fails past its retries the supervisor restores the
  last committed checkpoint and replays. The data pipeline is
  deterministic in (seed, step), so replayed batches are identical.
* **Step retry with backoff**: a failed step is retried after a seeded,
  capped exponential backoff; a failure that
  :func:`repro_torch.runtime.resilience.classify` calls persistent (a
  lowering or resource error: the same program cannot succeed again) skips
  the remaining retries and goes to restore-and-replay; a restore budget
  spent calls the elastic ``remesh_fn`` hook. The port's train step
  updates its state in place (JAX's donates it), so a failure after the
  update began (:class:`repro_torch.optim.StateConsumedError`, or a
  failure at the wait for the returned metrics, where the card's
  asynchronous errors surface) is never retried on that state: it goes
  straight to restore-and-replay, and raises when there is no checkpoint.
* **Straggler mitigation**: step wall times are kept in a rolling window;
  a step slower than ``straggler_factor`` x the median is logged and
  counted.

A step counts as done when its first metric (in tree order) is ready: a
CUDA tensor's device is synchronised, as ``jax.block_until_ready`` waits.

:class:`FaultInjector` raises at given steps, or at a seeded Bernoulli rate
a check, and (``dispatch_rate``) inside kernel dispatch
(:func:`repro_torch.runtime.resilience.check_faults`), seeded per backend.
Its numpy ``RandomState`` streams and its ``zlib.crc32`` mix of the seed
with the backend name are the JAX package's, so one seed injects at the
same calls in both packages for the same backend name. The injected
messages carry the port's markers (a CUDA out-of-memory, a failed ``nvcc``
build, a transient interruption), so that a chaos run exercises the real
classifier.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import statistics
import tempfile
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim.adamw import StateConsumedError
from repro_torch.parallel.sharding import tree_leaves

log = logging.getLogger("repro_torch.supervisor")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    max_retries_per_step: int = 2
    max_restores: int = 3
    max_remeshes: int = 2
    straggler_window: int = 32
    straggler_factor: float = 2.0
    log_every: int = 10
    # Seeded exponential backoff between step retries:
    # sleep = min(cap, base * 2**attempt) * (0.5 + u), u ~ U[0, 1) seeded —
    # back-to-back retries against a flapping device just burn the retry
    # budget inside the same failure window.
    retry_backoff_base: float = 0.05
    retry_backoff_cap: float = 2.0
    retry_backoff_seed: int = 0

# Injected dispatch-fault flavours map onto the resilience taxonomy THROUGH
# the real classifier: the messages carry the text of the failures the port
# really raises.
_DISPATCH_FAULT_MESSAGES = {
    "resource": ("injected dispatch fault: CUDA out of memory. Tried to allocate "
                 "the tile's planes"),
    "lowering": ("injected dispatch fault: CUDA kernel build failed: nvcc refused "
                 "the kernel source"),
    "transient": ("injected dispatch fault: UNAVAILABLE: transient backend "
                  "interruption"),
}


class FaultInjector:
    """Deterministic fault injection: raise at given steps, or (for
    sustained-load runs) at a seeded Bernoulli ``rate`` a check —
    reproducible across runs, independent of the wall clock.

    ``dispatch_rate`` arms the second injection site, INSIDE kernel
    dispatch, seeded per backend so every backend sees an independent
    reproducible fault stream. Injected dispatch faults rotate through
    ``dispatch_kinds`` (resource / lowering / transient). The ``reference``
    rung is exempt unless listed in ``dispatch_backends``: the oracle is the
    ladder's floor and must stay trustworthy for results to remain bitwise
    right under chaos.
    """

    def __init__(self, fail_at: Dict[int, int] = None, *,
                 rate: float = 0.0, seed: int = 0,
                 dispatch_rate: float = 0.0,
                 dispatch_backends: Optional[Tuple[str, ...]] = None,
                 dispatch_kinds: Tuple[str, ...] = ("resource", "lowering", "transient")):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"rate must be in [0, 1), got {rate}")
        if not 0.0 <= dispatch_rate < 1.0:
            raise ValueError(f"dispatch_rate must be in [0, 1), got {dispatch_rate}")
        unknown = set(dispatch_kinds) - set(_DISPATCH_FAULT_MESSAGES)
        if unknown:
            raise ValueError(
                f"unknown dispatch fault kinds {sorted(unknown)}; expected a subset of "
                f"{sorted(_DISPATCH_FAULT_MESSAGES)}")
        self.fail_at = dict(fail_at or {})   # step -> how many times to fail
        self.rate = rate
        self.seed = seed
        self._rng = np.random.RandomState(seed)
        self.injected = 0
        self.dispatch_rate = dispatch_rate
        self.dispatch_backends = (None if dispatch_backends is None
                                  else tuple(dispatch_backends))
        self.dispatch_kinds = tuple(dispatch_kinds)
        self._dispatch_rngs: Dict[str, np.random.RandomState] = {}
        self.dispatch_injected = 0

    def check(self, step: int):
        n = self.fail_at.get(step, 0)
        if n > 0:
            self.fail_at[step] = n - 1
            self.injected += 1
            raise RuntimeError(f"injected fault at step {step}")
        if self.rate and self._rng.random_sample() < self.rate:
            self.injected += 1
            raise RuntimeError(f"injected fault (rate={self.rate}) at step {step}")

    def _backend_rng(self, backend: str) -> np.random.RandomState:
        rng = self._dispatch_rngs.get(backend)
        if rng is None:
            # crc32, not hash(): stable across processes (PYTHONHASHSEED)
            mix = (self.seed ^ zlib.crc32(backend.encode())) & 0x7FFFFFFF
            rng = self._dispatch_rngs[backend] = np.random.RandomState(mix)
        return rng

    def check_dispatch(self, backend: str) -> None:
        """The kernel-dispatch injection site: a seeded Bernoulli draw per
        (backend, attempt), raising a classifiable fault."""
        if not self.dispatch_rate:
            return
        if self.dispatch_backends is not None:
            if backend not in self.dispatch_backends:
                return
        elif backend == "reference":
            return
        rng = self._backend_rng(backend)
        if rng.random_sample() < self.dispatch_rate:
            kind = self.dispatch_kinds[rng.randint(len(self.dispatch_kinds))]
            self.dispatch_injected += 1
            self.injected += 1
            raise RuntimeError(f"{_DISPATCH_FAULT_MESSAGES[kind]} [backend={backend}]")


def _block_until_ready(x) -> None:
    """Wait for ``x``: a CUDA tensor's device is synchronised."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class Supervisor:
    """Drives (state, batch) -> (state, metrics) with full fault tolerance."""

    def __init__(
        self,
        train_step: Callable,
        batch_fn: Callable[[int], Any],
        loop_cfg: TrainLoopConfig,
        fault_injector: Optional[FaultInjector] = None,
        remesh_fn: Optional[Callable[[Any], Any]] = None,
        sleep_fn: Callable[[float], None] = time.sleep,
    ):
        self.train_step = train_step
        self.batch_fn = batch_fn
        self.cfg = loop_cfg
        self.ckpt = CheckpointManager(loop_cfg.checkpoint_dir, async_saves=True)
        self.faults = fault_injector
        self.remesh_fn = remesh_fn
        self.sleep_fn = sleep_fn          # injectable: tests pass a recorder
        self._backoff_rng = np.random.RandomState(loop_cfg.retry_backoff_seed)
        self.step_times: deque = deque(maxlen=loop_cfg.straggler_window)
        self.stats = {"retries": 0, "restores": 0, "stragglers": 0, "remeshes": 0}
        self.history = []

    def _backoff(self, attempt: int) -> float:
        """Seeded, capped exponential backoff with jitter: deterministic
        given ``retry_backoff_seed``, never above ``retry_backoff_cap``."""
        cfg = self.cfg
        base = min(cfg.retry_backoff_cap, cfg.retry_backoff_base * (2 ** attempt))
        return base * (0.5 + self._backoff_rng.random_sample())

    def run(self, state) -> Any:
        from repro_torch.runtime import resilience

        cfg = self.cfg
        start = self.ckpt.latest_step()
        step = 0
        if start is not None:
            state, step = self.ckpt.restore(state, start)
            log.info("resumed from checkpoint step %d", step)
        restores = 0

        while step < cfg.total_steps:
            batch = self.batch_fn(step)
            ok = consumed = False
            for attempt in range(cfg.max_retries_per_step + 1):
                returned = False
                try:
                    t0 = time.time()
                    if self.faults is not None:
                        self.faults.check(step)
                    state, metrics = self.train_step(state, batch)
                    returned = True
                    _block_until_ready(tree_leaves(metrics)[0])
                    dt = time.time() - t0
                    self._track_straggler(step, dt)
                    ok = True
                    break
                except Exception as e:  # noqa: BLE001 — supervisor boundary
                    self.stats["retries"] += 1
                    log.warning("step %d attempt %d failed: %s", step, attempt, e)
                    if returned or isinstance(e, StateConsumedError):
                        # the update had begun writing the state in place: a
                        # retry would apply a second update on top of it
                        log.warning("step %d: the state is partly updated; restoring instead "
                                    "of retrying", step)
                        consumed = True
                        break
                    kerr = resilience.classify(e)
                    if isinstance(kerr, (resilience.KernelLoweringError,
                                         resilience.KernelResourceError)):
                        # persistent lowering/resource failure: the same
                        # program cannot succeed on retry — go straight to
                        # restore instead of burning the retry budget
                        log.warning("step %d: persistent %s; skipping remaining retries",
                                    step, type(kerr).__name__)
                        break
                    if attempt < cfg.max_retries_per_step:
                        self.sleep_fn(self._backoff(attempt))
            if not ok:
                restores += 1
                self.stats["restores"] += 1
                if restores > cfg.max_restores:
                    if self.remesh_fn is not None and self.stats["remeshes"] < cfg.max_remeshes:
                        log.error("restore budget exhausted; elastic re-mesh")
                        state = self.remesh_fn(state)
                        self.stats["remeshes"] += 1
                        restores = 0
                        continue
                    raise RuntimeError("restore + re-mesh budgets exhausted")
                self.ckpt.wait()              # drain in-flight async saves first
                last = self.ckpt.latest_step()
                if last is not None:
                    state, step = self.ckpt.restore(state, last)
                    log.warning("restored checkpoint step %d, replaying", step)
                elif consumed:
                    raise RuntimeError(f"step {step} failed after it began updating the state "
                                       f"in place, and there is no checkpoint to restore")
                continue

            if step % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                self.history.append({"step": step, **m})
                log.info("step %d: %s", step, {k: round(v, 4) for k, v in m.items()})
            step += 1
            if step % cfg.checkpoint_every == 0 or step == cfg.total_steps:
                self.ckpt.save(step, state)

        self.ckpt.wait()
        return state

    def _track_straggler(self, step: int, dt: float):
        if len(self.step_times) >= 8:
            med = statistics.median(self.step_times)
            if dt > self.cfg.straggler_factor * med:
                self.stats["stragglers"] += 1
                log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
        self.step_times.append(dt)
