"""repro_torch.checkpoint — atomic, async checkpoints with step management
(counterpart of ``repro/checkpoint``)."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
