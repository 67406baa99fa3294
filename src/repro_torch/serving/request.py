"""Requests and the bounded request queue (counterpart of
``repro/serving/request.py``, DESIGN.md §16).

A :class:`Request` is one user's token stream for one serving step: the
per-token expert assignments its router produced (routing/dispatch IS the
multisplit workload — the paper's building-block thesis at request level).
The queue is a plain FIFO with a depth bound; overflowing it is the
load-shedding signal, not an error.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Sequence

import numpy as np

__all__ = ["Request", "RequestQueue"]


@dataclasses.dataclass
class Request:
    """One queued unit of work.

    ``expert_ids`` is the (length,) int32 per-token expert assignment —
    host-side numpy on purpose: queued requests cost the card nothing, and
    the engine concatenates them into ONE padded buffer per step.
    ``arrival`` is the request's open-loop arrival time (latency is measured
    from here, so a slow submitter shows up as queueing delay, faithfully).
    ``requeues`` counts failed-step requeues; the engine drops the request
    (counted, deliberate) when it exceeds the configured budget.
    """

    rid: int
    expert_ids: np.ndarray
    arrival: float
    requeues: int = 0

    def __post_init__(self) -> None:
        self.expert_ids = np.asarray(self.expert_ids, np.int32).reshape(-1)
        self._n = int(self.expert_ids.shape[0])

    @property
    def length(self) -> int:
        return self._n


class RequestQueue:
    """Bounded FIFO of :class:`Request`.

    ``submit`` returns False (shed) past ``max_depth`` — admission control
    belongs to the caller's policy; the queue only enforces the hard bound
    that keeps an overloaded server's memory finite.
    """

    def __init__(self, max_depth: int) -> None:
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._q: Deque[Request] = deque()
        self._tokens = 0                    # maintained incrementally: O(1) reads

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def total_tokens(self) -> int:
        return self._tokens

    def submit(self, req: Request) -> bool:
        if len(self._q) >= self.max_depth:
            return False
        self._q.append(req)
        self._tokens += req.length
        return True

    def oldest(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def snapshot(self) -> List[Request]:
        """FIFO-ordered view (oldest first); does not pop."""
        return list(self._q)

    def remove(self, reqs: Sequence[Request]) -> None:
        """Pop an admitted subset (identity-matched; order-preserving for
        the rest). Scans from the HEAD only until every request is found —
        admission selects within a bounded head window, so this is O(window)
        regardless of backlog depth."""
        gone = {id(r) for r in reqs}
        kept: List[Request] = []
        while gone and self._q:
            r = self._q.popleft()
            if id(r) in gone:
                gone.discard(id(r))
                self._tokens -= r.length
            else:
                kept.append(r)
        for r in reversed(kept):
            self._q.appendleft(r)

    def requeue_front(self, reqs: Sequence[Request]) -> None:
        """Put a failed step's batch back at the HEAD in original order, so
        retried requests keep their age (and their place) over younger
        traffic. Bypasses ``max_depth``: these requests were already
        admitted once — shedding them here would turn a transient fault
        into silent request loss."""
        for r in reversed(list(reqs)):
            self._q.appendleft(r)
            self._tokens += r.length
