"""The CSR GET's chain walk over one tree edge (paper Fig. 4 and Fig. 11).

Each probe walks the child's same-key chain from its head ``hd`` while
the row is valid and the offset ``idx`` covers the row's weight, passing
weight-0 rows; it returns the row where it stopped (-1 past the chain, an
int32) and what is left of the offset (int64).

``csr_walk`` walks every probe from its head (the reference's vmapped
``_csr_walk``); ``csr_walk_cached`` resumes each probe from where the
previous probe with the same head stopped while its offset has not fallen
below what that walk consumed (the reference's ``lax.scan``
``_csr_walk_cached``, the paper's caching walk over ascending probes).
Both give the same rows and offsets. For CUDA tensors each launches
``csrc/csr_walk.cu`` (the design is there); for CPU tensors each runs its
plain version: ``csr_walk_plain`` steps every lane at once until none
moves, ``csr_walk_cached_plain`` is the scan as a literal loop, run by
run, for test sizes. ``csr_walk_cached_tiled`` is the plain model of the
caching kernel's tiles: the runs of equal heads of each tile, one walk a
run staging its chain prefix within the tile's budget, a search a probe,
and the fallback of runs that do not fit. Each wrapper's ``launches``
counts its kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import build

__all__ = ["TILE", "BUDGET", "csr_walk_plain", "csr_walk_cached_plain",
           "csr_walk_cached_tiled", "csr_walk", "csr_walk_cached"]

I32 = torch.int32
I64 = torch.int64
TILE = 128      # CW_TILE in csrc/csr_walk.cu: probes a block of the cache
BUDGET = 512    # CW_BUDGET: chain rows a tile stages
_REL_MAX = 0xFFFFFFFF  # a staged row's weight past the first's: 32 bits


def _check(weight, nxt, hd, idx) -> None:
    for name, t, dtype in (("weight", weight, I64), ("nxt", nxt, I32),
                           ("hd", hd, I32), ("idx", idx, I64)):
        if t.dtype != dtype or t.ndim != 1:
            raise ValueError(f"csr_walk: {name} must be a {dtype} vector, "
                             f"got {t.dtype} of shape {tuple(t.shape)}")
    if weight.shape != nxt.shape or hd.shape != idx.shape:
        raise ValueError("csr_walk: weight and nxt, hd and idx must match")
    if len({t.device for t in (weight, nxt, hd, idx)}) != 1:
        raise ValueError("csr_walk: operands on several devices")


def csr_walk_plain(weight: torch.Tensor, nxt: torch.Tensor, hd: torch.Tensor,
                   idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every lane one link a step, for as long as any lane moves (a host
    read a step); a lane stops where the reference's loop stops."""
    row, rem = hd.clone(), idx.clone()
    while True:
        live = row >= 0
        if not bool(live.any()):
            break
        at = torch.clamp(row, min=0).to(I64)
        w = weight[at]
        go = live & (rem >= w)
        if not bool(go.any()):
            break
        row = torch.where(go, nxt[at], row)
        rem = torch.where(go, rem - w, rem)
    return row, rem


def csr_walk_cached_plain(weight: torch.Tensor, nxt: torch.Tensor,
                          hd: torch.Tensor, idx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan, probe after probe on the host: the carry
    (head, row, consumed) resumes the walk while the head repeats and the
    offset is at least what was consumed. For test sizes only."""
    wl, nl = weight.tolist(), nxt.tolist()
    rows, rems = [], []
    prev_head, prev_row, prev_used = -2, -1, 0
    for h, i in zip(hd.tolist(), idx.tolist()):
        same = prev_head == h and i >= prev_used
        row, used = (prev_row, prev_used) if same else (h, 0)
        rem = i - used
        while row >= 0 and rem >= wl[row]:
            rem -= wl[row]
            used += wl[row]
            row = nl[row]
        rows.append(row)
        rems.append(rem)
        prev_head, prev_row, prev_used = h, row, used
    return (torch.tensor(rows, dtype=I32, device=hd.device),
            torch.tensor(rems, dtype=I64, device=hd.device))


_STATS = ("staged", "fallback", "single")


def csr_walk_cached_tiled(weight: torch.Tensor, nxt: torch.Tensor,
                          hd: torch.Tensor, idx: torch.Tensor, *,
                          tile: int = TILE, budget: int = BUDGET,
                          stats: Optional[Dict[str, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/csr_walk.cu``'s caching kernel as torch ops, equal to
    ``csr_walk``. The probes go by tiles of ``tile``; in each, the runs of
    equal heads (a run that spans tiles restarts in each). A run of two
    or more probes is walked once from its head, staging the rows from
    where its smallest offset stops to where its largest stops, each with
    its cumulative weight, within ``budget // W`` rows (W: the tile's runs
    of two or more); each probe searches them for the first row whose
    cumulative weight exceeds its offset, else takes the walk's end (the
    chain's, or, when the prefix did not fit, or its weight past the
    first staged row's passed 32 bits, the walk resumed from the last
    staged row on its own lane). A run of one probe walks from its head.
    ``stats``, when given, takes the runs staged, those that fell back
    (did not fit) and those of one probe."""
    _check(weight, nxt, hd, idx)
    if tile < 1 or budget < 0:
        raise ValueError(f"tile {tile} (>= 1), budget {budget} (>= 0)")
    m, dev = hd.numel(), hd.device
    row, rem = hd.clone(), idx.clone()
    counts = dict.fromkeys(_STATS, 0)
    if m:
        lane = torch.arange(m, device=dev)
        start = lane % tile == 0
        start[1:] |= hd[1:] != hd[:-1]
        run = torch.cumsum(start, 0) - 1
        first_lane = torch.nonzero(start).reshape(-1)
        nr = first_lane.numel()
        length = torch.bincount(run, minlength=nr)
        lo = torch.zeros(nr, dtype=I64, device=dev).scatter_reduce(
            0, run, idx, "amin", include_self=False)
        hi = torch.zeros(nr, dtype=I64, device=dev).scatter_reduce(
            0, run, idx, "amax", include_self=False)
        multi = length >= 2
        # the walkers: a run of two or more, numbered within its tile
        wk = torch.nonzero(multi).reshape(-1)
        wtile = first_lane[wk] // tile
        share = budget // torch.bincount(wtile)[wtile]
        wlo, whi = lo[wk], hi[wk]
        at_row = hd[first_lane[wk]].clone()
        cum = torch.zeros_like(wlo)
        first = torch.zeros_like(wlo)
        cnt = torch.zeros_like(wlo)
        over = torch.zeros_like(wlo, dtype=torch.bool)
        live = at_row >= 0
        staged = []  # (walker, entry, row, cumulative weight) a step
        while bool(live.any()):
            at = torch.clamp(at_row, min=0).to(I64)
            inc = cum + weight[at]
            stage = live & (inc > wlo)
            base = torch.where(cnt == 0, cum, first)
            full = stage & ((cnt == share) | (inc - base > _REL_MAX))
            over |= full
            stage &= ~full
            first = torch.where(stage & (cnt == 0), cum, first)
            s = torch.nonzero(stage).reshape(-1)
            staged.append((s, cnt[s], at_row[s], inc[s]))
            cnt = cnt + stage.to(I64)
            move = live & ~full & ~(stage & (inc > whi))
            cum = torch.where(move, inc, cum)
            at_row = torch.where(move, nxt[at], at_row)
            live = move & (at_row >= 0)
        end_row = torch.where(over, at_row, torch.full_like(at_row, -1))
        # the staged rows, walker after walker, and each walker's offset
        nwk = wk.numel()
        offs = torch.cumsum(cnt, 0) - cnt
        total = max(int(cnt.sum()), 1)
        s_row = torch.zeros(total, dtype=I32, device=dev)
        s_cum = torch.zeros(total, dtype=I64, device=dev)
        for s, k, r, c in staged:
            s_row[offs[s] + k] = r
            s_cum[offs[s] + k] = c
        # each probe of a walked run: a binary search of its run's rows
        walker = torch.full((nr,), -1, dtype=I64, device=dev)
        walker[wk] = torch.arange(nwk, device=dev)
        pw = walker[run]
        probe = pw >= 0
        pw = pw[probe]
        pi = idx[probe]
        seg = offs[pw]
        a, b = seg.clone(), seg + cnt[pw]
        while bool((a < b).any()):
            mid = (a + b) // 2
            gt = s_cum[torch.clamp(mid, max=total - 1)] > pi
            go = a < b
            b = torch.where(go & gt, mid, b)
            a = torch.where(go & ~gt, mid + 1, a)
        found = a < seg + cnt[pw]
        prev = torch.where(a > seg, s_cum[torch.clamp(a - 1, min=0)],
                           first[pw])
        r = torch.where(found, s_row[torch.clamp(a, max=total - 1)],
                        end_row[pw])
        m_rem = torch.where(found, pi - prev, pi - cum[pw])
        # the walk from where it ended: a resume past the staged rows
        r, m_rem = csr_walk_plain(weight, nxt, r, m_rem)
        row[probe], rem[probe] = r, m_rem
        single = ~probe
        row[single], rem[single] = csr_walk_plain(weight, nxt, hd[single],
                                                  idx[single])
        counts.update(staged=int((~over).sum()), fallback=int(over.sum()),
                      single=int((~multi).sum()))
    if stats is not None:
        stats.update(counts)
    return row, rem


_VP = ctypes.c_void_p


def _launch(weight, nxt, hd, idx, cached: bool,
            stats: Optional[Dict[str, int]] = None):
    fn = build.entry("csr_walk", "csr_walk_launch",
                     [_VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong,
                      ctypes.c_int, _VP, _VP])
    weight, nxt = weight.contiguous(), nxt.contiguous()
    hd, idx = hd.contiguous(), idx.contiguous()
    dev = hd.device
    row = torch.empty_like(hd)
    rem = torch.empty_like(idx)
    counts = torch.zeros(len(_STATS), dtype=I64, device=dev) \
        if stats is not None else None
    if hd.numel():
        wrapper = csr_walk_cached if cached else csr_walk
        with build.on_device(dev):
            build.check(fn(weight.data_ptr(), nxt.data_ptr(), hd.data_ptr(),
                           idx.data_ptr(), row.data_ptr(), rem.data_ptr(),
                           hd.numel(), int(cached),
                           counts.data_ptr() if counts is not None else None,
                           build.current_stream(dev)), wrapper.__name__)
        wrapper.launches += 1
    if counts is not None:
        stats.update(zip(_STATS, counts.tolist()))
    return row, rem


def _walk(weight, nxt, hd, idx, cached: bool, stats=None):
    _check(weight, nxt, hd, idx)
    if hd.device.type == "cpu":
        if stats is not None:
            # the kernel's counts come from its model; the result is the
            # plain version's all the same
            csr_walk_cached_tiled(weight, nxt, hd, idx, stats=stats)
        plain = csr_walk_cached_plain if cached else csr_walk_plain
        return plain(weight, nxt, hd, idx)
    if hd.device.type != "cuda":
        raise ValueError(f"csr_walk: unsupported device {hd.device}")
    return _launch(weight, nxt, hd, idx, cached, stats)


def csr_walk(weight: torch.Tensor, nxt: torch.Tensor, hd: torch.Tensor,
             idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight (n,) int64 and nxt (n,) int32: the child's weights and
    chain; hd (m,) int32 heads (-1: an empty run) and idx (m,) int64
    offsets. Returns (row (m,) int32, rem (m,) int64), each probe walked
    from its head."""
    return _walk(weight, nxt, hd, idx, cached=False)


csr_walk.launches = 0


def csr_walk_cached(weight: torch.Tensor, nxt: torch.Tensor,
                    hd: torch.Tensor, idx: torch.Tensor,
                    stats: Optional[Dict[str, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csr_walk`` with the paper's cache: the reference resumes the walk
    of the previous probe when the head repeats and its offset is at least
    what that walk consumed (ascending probes, as samplers emit them); the
    kernel shares one walk among a tile's probes of a head
    (``csr_walk_cached_tiled``). The same result as ``csr_walk``.
    ``stats``, when given, takes the runs staged, fallen back and of one
    probe (the kernel's own count on the card, ``csr_walk_cached_tiled``'s
    on the CPU, where the result is ``csr_walk_cached_plain``'s either
    way)."""
    return _walk(weight, nxt, hd, idx, cached=True, stats=stats)


csr_walk_cached.launches = 0
