"""Synthetic traffic generation + the open-loop simulation
(counterpart of ``repro/serving/traffic.py``; the same numpy streams, so
one seed gives both packages the same requests and arrivals).

Open-loop means arrivals are EXOGENOUS (a Poisson process at a target rate,
independent of server progress) — the honest serving benchmark regime: a
saturated server's queue grows and latency explodes instead of the
arrival process politely slowing down, so "sustained QPS at a p99 SLO"
measures real capacity. Closed-loop (:func:`closed_loop`) saturates the
queue up front and drains — the throughput-only regime the offline-oracle
CI floor compares against.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import ServerLoop

__all__ = [
    "poisson_arrivals", "synthetic_requests", "open_loop", "closed_loop",
]


def poisson_arrivals(n: int, qps: float, seed: int = 0) -> np.ndarray:
    """(n,) ascending arrival offsets (s) of a Poisson process at ``qps``."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def synthetic_requests(
    n: int,
    num_experts: int,
    seed: int = 0,
    mean_len: int = 16,
    max_len: int = 128,
    empty_fraction: float = 0.02,
) -> List[np.ndarray]:
    """n per-request expert-id streams with geometric-ish ragged lengths.

    A small ``empty_fraction`` of requests carry ZERO tokens this step (a
    user idling mid-stream) — the zero-length-segment path the plan layer
    pins must be hit by normal traffic, not only by tests.
    """
    rng = np.random.RandomState(seed)
    lengths = np.minimum(
        rng.geometric(1.0 / max(mean_len, 1), size=n), max_len
    ).astype(np.int64)
    lengths[rng.uniform(size=n) < empty_fraction] = 0
    return [
        rng.randint(0, num_experts, size=int(l)).astype(np.int32)
        for l in lengths
    ]


def open_loop(
    loop: ServerLoop,
    requests: Sequence[np.ndarray],
    arrivals: Sequence[float],
    *,
    sleep=time.sleep,
    poll_s: float = 2e-4,
) -> Dict[str, float]:
    """Drive ``loop`` with the given arrival schedule, then drain.

    Requests are stamped with their SCHEDULED arrival time, so submission lag
    shows up as queueing latency (it is). Between events the loop sleeps
    until the next arrival or the batching deadline, whichever is sooner.
    Returns the final metrics summary.
    """
    if len(requests) != len(arrivals):
        raise ValueError("requests and arrivals must align")
    t0 = loop.clock()
    i, n = 0, len(requests)
    while i < n:
        now = loop.clock() - t0
        while i < n and arrivals[i] <= now:
            loop.submit(requests[i], arrival=t0 + float(arrivals[i]))
            i += 1
        if loop.step() is not None:
            continue
        loop.flush()     # going idle: finalize the in-flight step's completions
        # idle: sleep to the next actionable instant
        waits = []
        if i < n:
            waits.append(arrivals[i] - (loop.clock() - t0))
        oldest = loop.queue.oldest()
        if oldest is not None:
            waits.append(loop.cfg.max_wait - (loop.clock() - oldest.arrival))
        wait = min(waits) if waits else 0.0
        if wait > 0:
            sleep(min(wait, 0.005))
        elif not waits:
            break
        else:
            sleep(poll_s)
    return loop.drain()


def closed_loop(
    loop: ServerLoop, requests: Sequence[np.ndarray],
    arrival: Optional[float] = None,
) -> Dict[str, float]:
    """Saturation regime: everything arrives at once, drain at full batches.
    The loop's queue bound must admit the whole set (size it accordingly)."""
    t0 = loop.clock() if arrival is None else arrival
    for r in requests:
        loop.submit(r, arrival=t0)
    return loop.drain()
