"""The comparison that decides ``correct``: the outputs the window kept,
against the plain reference worked out from the benchmark's own tables.

Numbers (each held against its limit in the cell's file):

- ``bad_rows``: rows of the kept draws that are not the join's row at
  their position, positions not strictly increasing or outside the join,
  and lanes that overflowed (exact: limit 0);
- ``same_draws``: pairs of kept draws, under different seeds, that drew
  the same positions (independence; exact: limit 0);
- ``count_z``: |sum of the kept draws' counts - the sum of their
  snapshots' E[k]| over the root of the sum of their variances;
- ``p_sum_z``: the same for the sum of the kept rows' p (each row's own,
  from the reference's table at its position), against the sum over join
  rows of p^2 and its variance, the sum of p^3 (1 - p): a sampler that
  keeps rows with another row's p, or with the mean p, moves it by about
  the join's variance of p, where ``count_z`` moves only by its
  covariance with the key groups' sizes;
- ``bad_join_rows``: rows of the kept full joins that differ from the
  reference's, plus the rows one has and the other lacks (exact: 0);
- ``bad_snapshot``: rows of the final snapshot that differ from the
  reference's replay of every delta the window and its warm-up applied,
  plus updates acknowledged out of order (exact: 0).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

BLOCK = 1 << 24   # join positions compared at a time


def _same(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elementwise equality; a value of another dtype is compared as the
    reference's dtype would hold it, so a lower precision shows."""
    if got.dtype != want.dtype:
        return got.to(torch.float64) == want.to(torch.float64)
    return got == want


def draws(kept: List[tuple], star_at) -> Dict[str, float]:
    """``kept`` is ``(version, sample)`` of whole batches; ``star_at(v)``
    the reference join of snapshot ``v``."""
    bad, dev, var, prints, lanes = 0, 0.0, 0.0, {}, []
    p_dev, p_var = 0.0, 0.0
    for version, smp in kept:
        star = star_at(version)
        ek, vk = star.expected_k(), star.variance_k()
        es, vs = star.expected_p_sum(), star.variance_p_sum()
        counts = smp.count.cpu().tolist()
        overflow = smp.overflow.cpu().tolist()
        for b, c in enumerate(counts):
            pos = smp.positions[b, :c].to(torch.int64).to(star.device)
            lanes.append((version, pos))
            dev += c - ek
            var += vk
            p_var += vs
            p_dev -= es
            if overflow[b]:
                bad += 1
            if c > 1:
                bad += int((pos[1:] <= pos[:-1]).sum())
            if c and (int(pos.min()) < 0 or int(pos.max()) >= star.size):
                bad += c
                continue
            p_dev += float(star.p[star.locate(pos)[0]].sum())
            want = star.rows_at(pos)
            for v, col in want.items():
                got = smp.columns[v][b, :c].to(star.device)
                bad += int((~_same(got, col)).sum())
            key = (version, c, int(pos.sum()), int((pos * pos).sum()))
            prints.setdefault(key, []).append(len(lanes) - 1)
    same = 0
    for idx in prints.values():
        for i in range(len(idx)):
            for j in range(i + 1, len(idx)):
                same += int(torch.equal(lanes[idx[i]][1], lanes[idx[j]][1]))
    z = abs(dev) / math.sqrt(var) if var > 0 else 0.0
    pz = abs(p_dev) / math.sqrt(p_var) if p_var > 0 else 0.0
    return {"bad_rows": bad, "same_draws": same, "count_z": z, "p_sum_z": pz,
            "draws_checked": len(lanes),
            "count_dev_per_draw": dev / len(lanes) if lanes else 0.0}


def joins(kept: List[Dict[str, torch.Tensor]], star) -> Dict[str, float]:
    bad = 0
    names = star.variables()
    for full in kept:
        n = min(int(next(iter(full.values())).shape[0]), star.size)
        bad += abs(int(next(iter(full.values())).shape[0]) - star.size)
        if set(full) != set(names):
            bad += star.size
            continue
        for lo in range(0, n, BLOCK):
            pos = torch.arange(lo, min(n, lo + BLOCK), device=star.device)
            want = star.rows_at(pos)
            for v in names:
                got = full[v][lo:lo + pos.numel()].to(star.device)
                bad += int((~_same(got, want[v])).sum())
    return {"bad_join_rows": bad, "joins_checked": len(kept)}


def snapshot(got: Dict[str, Dict[str, torch.Tensor]],
             want: Dict[str, Dict[str, torch.Tensor]],
             versions: List[int], first: int) -> Dict[str, float]:
    bad = sum(int(v != first + i) for i, v in enumerate(versions))
    for rel, cols in want.items():
        for c, w in cols.items():
            g = got[rel][c].to(w.device)
            n = min(g.shape[0], w.shape[0])
            bad += abs(g.shape[0] - w.shape[0])
            bad += int((~_same(g[:n], w[:n])).sum())
    return {"bad_snapshot": bad, "updates_checked": len(versions)}
