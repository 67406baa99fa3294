"""Serving observability: exact small-sample percentiles and the per-step /
per-request counters the continuous-batching loop exports (counterpart of
``repro/serving/metrics.py``, DESIGN.md §16).

Everything here is host-side bookkeeping — nothing touches the card. The
summary dict keeps the JAX package's keys: latency percentiles in
milliseconds, sustained QPS, queue/batch occupancy, and the robustness
counters (shed / retried / requeued / failed).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["percentiles", "ServingMetrics", "StepRecord"]


def percentiles(
    samples: Iterable[float], ps: Sequence[float] = (50.0, 95.0, 99.0)
) -> Dict[float, float]:
    """Exact nearest-rank percentiles (no interpolation): percentile ``p`` of
    ``n`` sorted samples is element ``ceil(p/100 * n) - 1`` (0-indexed), i.e.
    the smallest sample >= at least ``p`` percent of the data — numpy's
    ``method="inverted_cdf"``, which the unit tests pin.

    Interpolating estimators (numpy's default ``linear``) invent values
    between observations, which misleads exactly where serving percentiles
    matter: small tails. With 100 latency samples the p99 here IS an
    observed request latency, not a blend of the two slowest.  Empty input
    returns NaNs (a drained loop that never completed a request has no
    latency distribution).
    """
    xs = sorted(float(x) for x in samples)
    out: Dict[float, float] = {}
    for p in ps:
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if not xs:
            out[p] = float("nan")
            continue
        rank = max(1, math.ceil(p / 100.0 * len(xs)))     # p=0 -> the minimum
        out[p] = xs[rank - 1]
    return out


@dataclasses.dataclass
class StepRecord:
    """One executed serving step (one segmented plan launch)."""

    step: int
    requests: int
    tokens: int
    tokens_padded: int
    queue_depth: int          # depth BEFORE admission
    wall_s: float
    attempts: int = 1         # 1 = clean; >1 = in-step fault retries happened
    ok: bool = True


class ServingMetrics:
    """Counters + distributions for one :class:`~repro_torch.serving.ServerLoop`.

    Request accounting is conservative by construction and checked by
    :meth:`dropped_by_bug`: every submitted request ends in exactly one of
    ``completed`` / ``shed`` / ``failed`` / still-queued.  Anything else is
    a lost request — the serving acceptance criterion is that this never
    happens under sustained load.
    """

    def __init__(self) -> None:
        self.submitted = 0
        self.completed = 0
        self.shed = 0               # load-shedding rejections at submit time
        self.failed = 0             # requeue budget exhausted (dropped ON PURPOSE)
        self.retries = 0            # in-step launch retries
        self.requeued = 0           # requests put back after a failed step
        self.degradations = 0       # steps re-run on the reference backend (§17)
        self.verify_mismatches = 0  # sampled runtime-verification failures (§17)
        self.steps = 0
        self.empty_steps = 0        # step() polled with nothing admissible
        self.queue_depth_max = 0
        self.latencies_s: List[float] = []
        self.step_records: List[StepRecord] = []
        self.first_arrival: float | None = None
        self.last_completion: float | None = None

    # -- observation hooks -------------------------------------------------
    def observe_submit(self, arrival: float) -> None:
        self.submitted += 1
        if self.first_arrival is None or arrival < self.first_arrival:
            self.first_arrival = arrival

    def observe_shed(self) -> None:
        self.shed += 1

    def observe_queue_depth(self, depth: int) -> None:
        self.queue_depth_max = max(self.queue_depth_max, depth)

    def observe_step(self, rec: StepRecord) -> None:
        self.steps += 1
        self.step_records.append(rec)

    def observe_empty_step(self) -> None:
        self.empty_steps += 1

    def observe_completion(self, arrival: float, completion: float) -> None:
        self.completed += 1
        self.latencies_s.append(max(0.0, completion - arrival))
        if self.last_completion is None or completion > self.last_completion:
            self.last_completion = completion

    # -- derived -----------------------------------------------------------
    def dropped_by_bug(self, still_queued: int) -> int:
        """Requests unaccounted for: MUST be zero (acceptance criterion)."""
        return (self.submitted - self.completed - self.shed - self.failed
                - still_queued)

    def occupancy(self) -> Tuple[float, float]:
        """(mean token occupancy of the padded buffer, mean request
        occupancy of the segment axis' admission cap) over executed steps."""
        recs = [r for r in self.step_records if r.ok]
        if not recs:
            return 0.0, 0.0
        tok = sum(r.tokens / max(r.tokens_padded, 1) for r in recs) / len(recs)
        req = sum(r.requests for r in recs) / len(recs)
        return tok, req

    def summary(self) -> Dict[str, float]:
        """The exported metrics dict (the BENCH trajectory unit)."""
        pct = percentiles(self.latencies_s)
        lat = self.latencies_s
        wall = 0.0
        if self.first_arrival is not None and self.last_completion is not None:
            wall = max(self.last_completion - self.first_arrival, 0.0)
        qps = self.completed / wall if wall > 0 else float("nan")
        tok_occ, req_mean = self.occupancy()
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed": self.shed,
            "failed": self.failed,
            "retries": self.retries,
            "requeued": self.requeued,
            "degradations": self.degradations,
            "verify_mismatches": self.verify_mismatches,
            "steps": self.steps,
            "empty_steps": self.empty_steps,
            "queue_depth_max": self.queue_depth_max,
            "latency_p50_ms": pct[50.0] * 1e3,
            "latency_p95_ms": pct[95.0] * 1e3,
            "latency_p99_ms": pct[99.0] * 1e3,
            "latency_mean_ms": (sum(lat) / len(lat) * 1e3) if lat else float("nan"),
            "qps_sustained": qps,
            "wall_s": wall,
            "batch_token_occupancy": tok_occ,
            "batch_requests_mean": req_mean,
        }
