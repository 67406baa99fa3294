"""Admission/batching policy: which queued requests form the next step's
batch (counterpart of ``repro/serving/admission.py``, DESIGN.md §16).

Three controls, all standard continuous-batching levers:

* ``max_batch_tokens`` / ``max_batch_requests`` — the step budget (the
  padded flat buffer and the segment axis of the ONE segmented plan launch).
* ``max_wait`` — the flush deadline: a step fires as soon as the batch is
  full OR the oldest queued request has waited this long (tail latency
  control under light load).
* **Length bucketing via** :class:`~repro_torch.ops.RangeSpec` — the
  admission ORDER. Queued request lengths are bucketed by ONE splitter-based
  ``repro_torch.ops.multisplit`` call on the configured backend and device
  (on ``cuda``: K1 and K2, key-value; the same splitter-bucketing primitive that
  opens GPU sample sort), so each batch is built from length-similar
  requests and the padded buffer wastes as little as possible. The
  multisplit is stable, so FIFO order survives within a length class, and
  admission starts from the OLDEST request's class (rotating through the
  rest), so bucketing can never starve a class.

The policy is pure host-side selection: it never launches device work
beyond the (small, padded, plan-cached) length-bucketing call. There is no
jit: the lengths are padded to powers of two so that the ops' plan cache
holds a handful of shapes and stays warm.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.serving.request import Request, RequestQueue

__all__ = ["AdmissionConfig", "AdmissionPolicy"]

# Queue-depth padding classes for the length-bucketing multisplit: the
# lengths vector is padded to the next power of two so the plan cache stays
# logarithmic in the observed depths, not linear.
_MIN_BUCKETING_PAD = 8

# Admission looks at a bounded FIFO window of the queue, not the whole
# backlog: a few batches' worth is enough to group by length, and it caps
# both the host-side packing cost per step and the bucketing shape ladder.
# (Default for AdmissionConfig.lookahead_batches; a saturation benchmark
# may raise it — a wider window packs closer to the offline oracle.)
LOOKAHEAD_BATCHES = 4


def _bucketing_op(lengths: np.ndarray, idx: np.ndarray, spec, backend: str, device):
    """The (lengths, idx) -> bucket-major reorder: one key-value
    ``ops.multisplit`` on ``backend`` and ``device`` (specs hash by value,
    so each padded depth reuses its cached plan), brought back to the
    host as (order, counts). It runs outside the ops' ladder, as the JAX
    package's jitted op does: a failure propagates to the serving loop."""
    from repro_torch import ops
    from repro_torch.runtime import resilience as _rz

    with _rz.bypass():               # as the JAX package's jitted op
        res = ops.multisplit(lengths, spec, idx, backend=backend, device=device)
    return res.values.cpu().numpy(), res.bucket_counts.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    max_batch_requests: int = 64
    max_batch_tokens: int = 4096
    max_wait: float = 0.02                       # seconds
    # RangeSpec splitters over request LENGTH (ascending). () disables
    # bucketing (pure FIFO admission).
    length_splitters: Tuple[int, ...] = (32, 128)
    backend: str = "cuda"
    lookahead_batches: int = LOOKAHEAD_BATCHES
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.max_batch_requests < 1:
            raise ValueError("max_batch_requests must be >= 1")
        if self.max_batch_tokens < 1:
            raise ValueError("max_batch_tokens must be >= 1")
        if self.lookahead_batches < 1:
            raise ValueError("lookahead_batches must be >= 1")
        if list(self.length_splitters) != sorted(set(self.length_splitters)):
            raise ValueError(
                f"length_splitters must be strictly ascending, got "
                f"{self.length_splitters}"
            )


class AdmissionPolicy:
    def __init__(self, cfg: AdmissionConfig) -> None:
        self.cfg = cfg
        self._spec = None                   # lazily-built length RangeSpec
        # Batches carved but not yet admitted: ONE bucketing call plans the
        # whole lookahead window (popped from the queue in ONE scan), then
        # consecutive steps pop from the plan — the per-step admission cost
        # amortizes over the window.
        self._plan: Deque[List[Request]] = deque()

    def pending(self) -> int:
        """Requests already popped from the queue into the pending plan
        (still owned by admission, not yet admitted to a step)."""
        return sum(len(b) for b in self._plan)

    def invalidate(self, queue: RequestQueue) -> None:
        """Return the pending plan's requests to the queue HEAD in order
        (call when the head must change under the plan — e.g. a failed step
        requeued its batch; planned requests must not be lost OR jumped)."""
        if self._plan:
            queue.requeue_front([r for b in self._plan for r in b])
            self._plan.clear()

    # -- flush condition ---------------------------------------------------
    def ready(self, queue: RequestQueue, now: float) -> bool:
        """A step should fire: full batch available, or deadline expired."""
        if self._plan:
            return True               # planned batches were admitted-ready
        oldest = queue.oldest()
        if oldest is None:
            return False
        if now - oldest.arrival >= self.cfg.max_wait:
            return True
        if queue.depth >= self.cfg.max_batch_requests:
            return True
        return queue.total_tokens() >= self.cfg.max_batch_tokens

    # -- length bucketing --------------------------------------------------
    def length_groups(self, reqs: Sequence[Request]) -> List[List[int]]:
        """Bucket request indices by length class via ONE ``repro_torch.ops``
        splitter multisplit (stable: FIFO preserved within a class).
        Returns the non-empty groups in ascending-class order."""
        from repro_torch import ops

        if not reqs:
            return []
        if not self.cfg.length_splitters:
            return [list(range(len(reqs)))]
        depth = len(reqs)
        pad = _MIN_BUCKETING_PAD
        while pad < depth:
            pad *= 2
        if self._spec is None:
            self._spec = ops.range_buckets(
                np.asarray(self.cfg.length_splitters, np.int32)
            )
        spec = self._spec
        lengths = np.full((pad,), np.int32(spec.pad_key(torch.int32)))
        lengths[:depth] = [r.length for r in reqs]
        idx = np.arange(pad, dtype=np.int32)
        order, counts = _bucketing_op(lengths, idx, spec, self.cfg.backend, self.cfg.device)
        groups: List[List[int]] = []
        at = 0
        for c in counts:
            grp = [int(i) for i in order[at:at + int(c)] if i < depth]
            at += int(c)
            if grp:
                groups.append(grp)
        return groups

    # -- batch selection ---------------------------------------------------
    def _carve_batch(self, remaining: List[Request]) -> List[Request]:
        """Greedy skip-fill of one batch from ``remaining`` (in admission
        order), consuming the chosen requests."""
        batch: List[Request] = []
        tokens = 0
        left: List[Request] = []
        for r in remaining:
            if (len(batch) >= self.cfg.max_batch_requests
                    or (batch and tokens + r.length > self.cfg.max_batch_tokens)):
                left.append(r)        # skip-fill: later short requests may fit
                continue
            batch.append(r)
            tokens += r.length
        remaining[:] = left
        return batch

    def admit(self, queue: RequestQueue, now: float,
              force: bool = False) -> List[Request]:
        """Pop and return the next batch (possibly empty).

        ``force=True`` skips the :meth:`ready` gate (drain path). Selection
        walks the length groups starting from the oldest request's class —
        the deadline that fired belongs to that request, so its class leads
        — and greedily fills the token/request budget in stable FIFO order
        within each class. The whole lookahead window is carved into batches
        at once (one bucketing call) and later steps pop from that plan."""
        if not force and not self.ready(queue, now):
            return []
        if self._plan:
            return self._plan.popleft()   # already popped from the queue
        window = self.cfg.lookahead_batches * self.cfg.max_batch_requests
        reqs = queue.snapshot()[:window]
        if not reqs:
            return []
        groups = self.length_groups(reqs)
        # rotate: the group containing index 0 (the OLDEST request) first
        lead = next(i for i, g in enumerate(groups) if 0 in g)
        groups = groups[lead:] + groups[:lead]
        # pop the WHOLE window in one head scan; carve it into batches
        queue.remove(reqs)
        remaining = [reqs[i] for g in groups for i in g]
        batch = self._carve_batch(remaining)
        while remaining:
            b = self._carve_batch(remaining)
            if (remaining or len(b) >= self.cfg.max_batch_requests
                    or sum(r.length for r in b) >= self.cfg.max_batch_tokens):
                self._plan.append(b)
            else:
                # trailing underfull remainder: back to the queue HEAD so the
                # next window rebatches it densely with younger arrivals —
                # otherwise every window ships one partial batch and steady-
                # state occupancy is capped by the window size
                queue.requeue_front(b)
        return batch
