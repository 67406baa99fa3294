"""LR schedules: cosine and WSD (Warmup-Stable-Decay, minicpm
arXiv:2404.06395); counterpart of ``repro/optim/schedules.py``.

A schedule takes the step as a number or a tensor and returns the rate as a
float32 tensor (on the step's device), computed in float32 in JAX's order of
operations, so a train step reads it without a host copy."""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def make_schedule(tc: TrainConfig):
    warmup = max(tc.warmup_steps, 1)
    total = tc.total_steps

    def _step(step) -> torch.Tensor:
        return torch.as_tensor(step).to(torch.float32)

    def cosine(step):
        step = _step(step)
        warm = torch.clamp(step / warmup, max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return tc.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))

    def wsd(step):
        """Warmup -> Stable (flat) -> Decay (exponential-ish tail)."""
        step = _step(step)
        warm = torch.clamp(step / warmup, max=1.0)
        decay_start = int(total * tc.decay_start)
        frac = torch.clamp((step - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
        decay = 0.5 ** (frac * 8.0)   # ~2^-8 at the end, per minicpm's sharp tail
        return tc.lr * warm * torch.where(step < decay_start, 1.0, decay)

    return {"cosine": cosine, "wsd": wsd}[tc.schedule]
