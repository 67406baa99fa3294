"""repro_torch.optim — AdamW, LR schedules and int8 gradient compression
(counterpart of ``repro/optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState,
    StateConsumedError,
    adamw_init,
    adamw_update,
)
from repro_torch.optim.schedules import make_schedule  # noqa: F401
