"""repro_torch.runtime — the resilience layer (counterpart of
``repro/runtime``): the failure taxonomy, the degradation ladder, the
circuit breaker and its quarantine sidecar, runtime verification, and the
seeded fault injector. The JAX package's training supervisor
(``Supervisor``, ``TrainLoopConfig``) comes with the training stack
(ROADMAP A13)."""

from repro_torch.runtime.supervisor import FaultInjector  # noqa: F401
from repro_torch.runtime.resilience import (  # noqa: F401
    DEMOTION_ORDER,
    DispatchContext,
    KernelContextError,
    KernelDispatchError,
    KernelLoweringError,
    KernelResourceError,
    KernelResultError,
    TransientDispatchError,
    classify,
    dispatch,
    fallback,
    set_fallback,
    set_fault_injector,
    set_strict,
    set_verify,
    verify_level,
)
from repro_torch.runtime import resilience  # noqa: F401
