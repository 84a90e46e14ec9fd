"""Learning-rate schedules (``repro.optim.schedules``): each maps an
int32 step-count tensor to a float32 learning-rate tensor on its
device."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32,
                                      device=count.device)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def sched(count):
        t = torch.clamp(count.to(torch.float32), max=decay_steps) \
            / decay_steps
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)
    return sched


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.0):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def sched(count):
        c = count.to(torch.float32)
        warm = lr * c / max(warmup_steps, 1)
        return torch.where(c < warmup_steps, warm, cos(count - warmup_steps))
    return sched
