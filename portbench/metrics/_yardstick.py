"""The benchmark's frozen arithmetic: the nearest-rank percentile, the
H100's published peaks, the byte and operation counts of the kernels
whose roofline share the benchmark reports, and the reduction of a
profiler trace to busy time and idle gaps.

Copied from the program (``launch/metrics.py`` ``percentile``,
``chip_smoke.py`` ``bound`` / ``draw_bound`` / ``walk_ops``) so that a
change to the program cannot move the yardstick; the counts are corrected
to count what these inputs need: every input byte read once, every output
byte written once, sizes from the tables and the rows actually drawn,
never from the program's capacities or index layout.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank q-th percentile of ``xs`` (q in [0, 1]): the
    ``ceil(q * N)``-th smallest, clamped to the sample."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    if len(xs) == 0:
        raise ValueError("percentile of an empty sequence")
    ys = sorted(xs)
    return ys[max(1, math.ceil(q * len(ys))) - 1]


def bound_s(nbytes: float, nops: float,
            ops_per_s: float = SCALAR_OPS_PER_S) -> float:
    """The least seconds the card could take: bytes at the memory rate or
    operations at the compute rate, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)


def steps(n: float) -> int:
    """Steps of a binary search over ``n`` entries."""
    return max(1, math.ceil(math.log2(max(n, 2))))


def draw_batch_work(roots: int, children: Sequence[int], arrivals: float,
                    counts: Sequence[int], walk: bool) -> Tuple[float, float]:
    """(bytes, operations) of one batched EXPRACE draw of ``len(counts)``
    keys over a star join: ``roots`` root rows, ``children`` the child
    relations' rows; ``arrivals`` the expected arrivals of one key (the
    sum over join rows of -log(1 - p)); ``counts`` the rows each key
    drew. Bytes: the seven per-root parameter vectors read once, each
    key's positions and scalars written once, and with the walk the index
    (a prefix word a row) read once and a row id a relation written for
    every row drawn. Operations: each arrival's random bits, logarithm and
    two searches over the roots; each root's search into the arrivals;
    each row's searches; with the walk, a descent a relation."""
    keys = len(counts)
    k = float(sum(counts))
    s_r, s_a = steps(roots + 2), steps(arrivals + 1)
    ops = (keys * arrivals * (150 + 6 * 2 * s_r + 40)
           + keys * (roots + 1) * 6 * s_a
           + k * (6 * (s_r + 2 * s_a) + 30))
    nbytes = 4 * 7 * (roots + 1) + 4 * (k + 2 * keys)
    if walk:
        nbytes += 4 * (roots + 1 + sum(children)) + 4 * k * (1 + len(children))
        walk_ops = 6 * steps(roots + 1) + sum(6 * steps(c + 1) + 12
                                              for c in children)
        ops += k * walk_ops
    return nbytes, ops


def get_work(relations: Sequence[int], positions: int,
             search_steps: float) -> Tuple[float, float]:
    """(bytes, operations) of the GET of ``positions`` join positions over
    a star join of ``relations`` rows each: the positions read once, the
    index (a prefix word a row of every relation) read once, a row id a
    relation written for every position. Operations: ``search_steps``
    binary-search steps (``get_search_steps``), 6 operations each, and 12
    a relation for every position."""
    nbytes = 4 * positions + 4 * sum(relations) + 4 * positions * len(relations)
    ops = 6 * search_steps + 12 * positions * len(relations)
    return nbytes, ops


def get_search_steps(roots: int, block_rows, child_degrees) -> float:
    """The binary-search steps the GET of every join position needs: each
    position's search over the roots' prefix, and inside each child's key
    group one over the group's rows. ``block_rows`` is the join rows under
    each root row, ``child_degrees`` each child's group size under each
    root row (1-D tensors of the roots' length)."""
    import torch

    w = block_rows.to(torch.float64)
    per_root = float(steps(roots + 1)) * torch.ones_like(w)
    for d in child_degrees:
        per_root += torch.ceil(torch.log2(d.clamp_min(2).to(torch.float64)))
    return float((w * per_root).sum())


def busy_union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals, merged and sorted."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Iterable[Tuple[int, int]], lo: int, hi: int):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def idle_gaps(busy: Sequence[Tuple[int, int]], lo: int,
              hi: int) -> List[Tuple[int, int]]:
    """The gaps of the window ``[lo, hi)`` that no busy interval covers."""
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def top_by_name(items: Iterable[Tuple[str, float]], n: int = 10):
    """``[[name, total], ...]`` of the ``n`` names with the largest totals."""
    tot: Dict[str, float] = {}
    for name, v in items:
        tot[name] = tot.get(name, 0.0) + v
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def clip_named(ops, lo: int, hi: int):
    """``(name, start, end)`` operations clipped to ``[lo, hi)``."""
    return [(n, max(a, lo), min(b, hi)) for n, a, b in ops
            if min(b, hi) > max(a, lo)]
