"""Sample-size estimation and capacity planning.

Samplers draw into a fixed-capacity buffer. The expected Poisson sample
size and its variance are exactly computable from the index in O(|N|):
    E[k] = sum_t w_t * p_t,     Var[k] = sum_t w_t * p_t * (1 - p_t)
Capacity = E + sigmas * sqrt(Var) + slack covers overflow with probability
~1 - 1e-9 at sigmas=6; the plan redraws with doubled capacity on overflow.
"""
from __future__ import annotations

import math

import torch

__all__ = ["expected_sample_size", "sample_std", "exprace_arrival_mass",
           "plan_capacity", "round_up"]

F64 = torch.float64


def expected_sample_size(w, p) -> torch.Tensor:
    return torch.sum(w.to(F64) * p.to(F64))


def sample_std(w, p) -> torch.Tensor:
    p = p.to(F64)
    return torch.sqrt(torch.sum(w.to(F64) * p * (1.0 - p)))


def exprace_arrival_mass(w, p) -> torch.Tensor:
    """Expected raw Poisson-arrival count of the EXPRACE sampler:
    Lam = sum_t w_t * (-ln(1 - min(p_t, 1-p_t)))."""
    p = torch.clamp(p.to(F64), 0.0, 1.0)
    pi = torch.minimum(p, 1.0 - p)
    return torch.sum(w.to(F64) * (-torch.log1p(-torch.clamp(pi, max=0.5))))


def round_up(x: int, multiple: int = 128) -> int:
    return int(-(-x // multiple)) * multiple


def plan_capacity(mean: float, std: float, sigmas: float = 6.0, slack: int = 64,
                  multiple: int = 128) -> int:
    """Static capacity for a sampler invocation (a multiple of 128)."""
    cap = int(math.ceil(float(mean) + sigmas * float(std))) + slack
    return round_up(max(cap, multiple), multiple)
