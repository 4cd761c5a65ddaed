"""Learning-rate schedules (``repro.training.schedule``'s counterpart):
callables of a step, each a 0-d tensor on the device of the step
counter, float32 out, so an optimizer reads its rate with no host sync.
A plain Python number as the step gives a 0-d CPU tensor.
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then a cosine
    down to ``final_frac · peak`` at ``total_steps``, the reference's
    operations in its order."""
    def f(step):
        step = _step(step)
        warm = peak * step / max(1, warmup_steps)
        progress = torch.clamp((step - warmup_steps)
                               / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = final_frac * peak + (1 - final_frac) * peak * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, cos)

    return f


def linear_decay(peak: float, total_steps: int):
    def f(step):
        frac = torch.clamp(1.0 - _step(step) / max(1, total_steps), 0.0, 1.0)
        return peak * frac

    return f
