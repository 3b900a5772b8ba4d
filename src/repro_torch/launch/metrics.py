"""Latency metrics shared by the serve loop and the fleet router.

``percentile`` is the *nearest-rank* estimator: the q-th percentile of a
sample of N values is the ``ceil(q * N)``-th smallest (1-indexed), clamped
to the sample. p50 of ``[1, 2, 3, 4]`` is 2 (the 2nd smallest), and p99
of a short list is its maximum only when ``ceil(0.99 * N) == N``.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

__all__ = ["percentile", "latency_summary"]


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank q-th percentile of ``xs`` (q in [0, 1])."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    if len(xs) == 0:
        raise ValueError("percentile of an empty sequence")
    ys = sorted(xs)
    rank = max(1, math.ceil(q * len(ys)))  # 1-indexed nearest rank
    return ys[rank - 1]


def latency_summary(latencies_s: Sequence[float]) -> Dict[str, float]:
    """p50/p99/max of a latency sample, in milliseconds."""
    if len(latencies_s) == 0:
        return {"p50_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
    return {
        "p50_ms": percentile(latencies_s, 0.50) * 1e3,
        "p99_ms": percentile(latencies_s, 0.99) * 1e3,
        "max_ms": max(latencies_s) * 1e3,
    }
