"""LR schedules (pure functions of the step), ``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def _cos(x: torch.Tensor) -> torch.Tensor:
    """float32 cosine, correctly rounded but in rare cases: the float64
    cosine rounded once. XLA's float32 cosine is closer to that than
    torch's float32 kernel, and ``1 + cos`` near -1 magnifies an ulp."""
    return torch.cos(x.to(torch.float64)).to(torch.float32)


def warmup_cosine(step, *, warmup: int, total: int, floor: float = 0.1
                  ) -> torch.Tensor:
    """Linear warmup then cosine decay to ``floor`` x peak. Returns the LR
    *scale* in [0, 1] (multiply by the optimizer's peak lr) as a 0-d
    float32 tensor on the CPU, computed in float32 as the reference does:
    every Python constant enters as a float32 operand (the cosine is taken
    as ``_cos`` says)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + _cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
