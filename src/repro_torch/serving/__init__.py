"""repro_torch.serving — continuous-batching serving over the plan layer
(counterpart of ``repro/serving``, DESIGN.md §16).

The request-level consumer of the segmented multisplit: a bounded
:class:`RequestQueue`, a RangeSpec-length-bucketing :class:`AdmissionPolicy`,
the :class:`ServerLoop` step engine (ONE segmented routing launch per step,
warm plans, fault retry/requeue, load shedding, graceful drain, the
resilience layer's degradation and verification), :class:`ServingMetrics`
(p50/p95/p99, sustained QPS, occupancy, conservation check), and the
open-loop traffic simulator. Steps run on ``device``, the card by default.
"""

from repro_torch.serving.admission import AdmissionConfig, AdmissionPolicy
from repro_torch.serving.engine import ServerLoop, ServingConfig
from repro_torch.serving.metrics import ServingMetrics, StepRecord, percentiles
from repro_torch.serving.request import Request, RequestQueue
from repro_torch.serving.traffic import (
    closed_loop,
    open_loop,
    poisson_arrivals,
    synthetic_requests,
)

__all__ = [
    "AdmissionConfig", "AdmissionPolicy",
    "ServerLoop", "ServingConfig",
    "ServingMetrics", "StepRecord", "percentiles",
    "Request", "RequestQueue",
    "closed_loop", "open_loop", "poisson_arrivals", "synthetic_requests",
]
