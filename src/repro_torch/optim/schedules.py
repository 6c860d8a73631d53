"""LR schedules as functions of the step (``repro.optim.schedules``).

The step may be a Python number or a device tensor (the optimizer's
int32 step counter): every operation here stays on the tensor's device,
so that a schedule read inside the train step never waits for the
device."""
from __future__ import annotations

import math

import torch


def _as_float(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup(step, warmup_steps: int) -> torch.Tensor:
    return torch.clamp((_as_float(step) + 1) / max(warmup_steps, 1),
                       max=1.0)


def cosine_schedule(step, total_steps: int, warmup_steps: int = 0,
                    final_frac: float = 0.1) -> torch.Tensor:
    warm = linear_warmup(step, warmup_steps)
    t = torch.clamp((_as_float(step) - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return warm * (final_frac + (1.0 - final_frac) * cos)
