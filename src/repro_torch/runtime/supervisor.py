"""Seeded fault injection for the resilience layer and the serving loop
(counterpart of ``repro/runtime/supervisor.py:63-155``).

:class:`FaultInjector` raises at given steps, or at a seeded Bernoulli rate
a check, and (``dispatch_rate``) inside kernel dispatch
(:func:`repro_torch.runtime.resilience.check_faults`), seeded per backend.
Its numpy ``RandomState`` streams and its ``zlib.crc32`` mix of the seed
with the backend name are the JAX package's, so one seed injects at the
same calls in both packages for the same backend name. The injected
messages carry the port's markers (a CUDA out-of-memory, a failed ``nvcc``
build, a transient interruption), so that a chaos run exercises the real
classifier.

The JAX module's training supervisor (``Supervisor``, ``TrainLoopConfig``)
drives a training loop over its checkpoint manager and comes with the
training stack (ROADMAP A13).
"""

from __future__ import annotations

import zlib
from typing import Dict, Optional, Tuple

import numpy as np

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
