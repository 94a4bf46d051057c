"""Learning-rate schedules, ported from ``repro.optim.schedules`` (the
paper uses a constant, grid-searched step).  Each returns step -> a
float32 scalar tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def warmup_cosine(lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * (floor + (1 - floor) * 0.5
                    * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return fn
