"""Bulk binary search of int32 probes into a sorted int32 prefix vector:
for each query q, the largest j with ``pref[j] <= q`` (``pref[0] == 0``).

The inner loop of USR-GET's root location and of EXPRACE's prefix
searches. ``bsearch_probe`` launches ``csrc/bsearch_probe.cu`` for CUDA
tensors and runs ``bsearch_probe_plain`` for CPU tensors; ``launches``
counts kernel launches.

The kernel searches by tiles of queries (the design is in
``csrc/bsearch_probe.cu``): the GET's search of one vector
(``csrc/tree_get.cuh`` ``tg_search``), a tile's bracket staged in shared
memory when it is at most ``SPAN`` wide, else a per-lane descent whose
first ``LEVELS`` steps read a pivot table. ``bsearch_probe_tiled`` spells
that logic out as torch ops, and this module holds the one-vector pieces
of it that ``tree_probe.tree_walk_tiled`` builds on.

The tile is ``block_rows`` rows of 128 queries (``autotune``'s parameter:
2, 4, 8 or 16, an instance of the kernel each, 256 threads x
``block_rows / 2`` queries a thread); ``None`` is the builtin 8 (``TILE``,
1,024 queries). ``ops.searchsorted_prefix`` resolves it through
``autotune.tile_for``; a value that names no instance raises.

``out_of_bounds`` launches the kernel's checked build
(``build.VARIANTS`` ``bsearch_probe_checked``) as ``bsearch_probe``
launches the kernel: a measurement, counted in no ``launches``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import build
from .autotune import check_value, count_tile

__all__ = ["THREADS", "ITEMS", "SPAN", "LEVELS", "steps_for",
           "bsearch_probe_plain", "bsearch_probe_tiled", "bsearch_probe",
           "bsearch_probe_config", "TILE", "items_for", "out_of_bounds"]

# The kernels' constants (``tests/test_torch_bsearch.py`` holds them to
# the sources' ``#define`` lines).
THREADS = 256   # TG_THREADS in csrc/tree_get.cuh: threads of a block
ITEMS = 4       # BP_ITEMS in csrc/bsearch_probe.cu: queries a thread of
                # the builtin tile
SPAN = 2048     # TG_SPAN: the widest bracket a tile stages in shared memory
LEVELS = 10     # TG_LEVELS: descent steps a pivot table holds (2^LEVELS values)
TILE = THREADS * ITEMS  # queries a tile of the builtin block_rows (8)


def items_for(block_rows: Optional[int]) -> int:
    """Queries a thread of the kernel's instance for ``block_rows`` (rows of
    128 queries; ``None`` the builtin). Raises on a value that names no
    instance."""
    if block_rows is None:
        return ITEMS
    return check_value("bsearch_probe", block_rows) * 128 // THREADS


def steps_for(length: int) -> int:
    """Descent steps over a vector of ``length``: max(1, ceil(log2 L))."""
    return max(1, (max(length, 2) - 1).bit_length())


def bsearch_probe_plain(pref: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The reference's branchless power-of-two descent as torch ops."""
    np_len = pref.shape[0]
    pos = torch.zeros_like(q, dtype=torch.int32)
    for k in range(steps_for(np_len) - 1, -1, -1):
        cand = pos + (1 << k)
        val = pref[torch.clamp(cand, max=np_len - 1)]
        take = (cand < np_len) & (val <= q)
        pos = torch.where(take, cand, pos)
    return pos


# ---------------------------------------------------------------------------
# The search of one vector by tiles (csrc/tree_get.cuh tg_search) as torch
# ops, all tiles at once: a tile is a row of ``qt`` (tiles, tile), values
# int64.
# ---------------------------------------------------------------------------

def _pivot_descend(piv, length: int, steps: int, sh: int, q):
    """``tg_pivot_descend``: the descent's steps above 2^sh, read from the
    pivot table; the answer then lies in [p, p + 2^sh - 1]."""
    p = torch.zeros_like(q)
    for k in range(steps - 1, sh - 1, -1):
        cand = p + (1 << k)
        p = torch.where((cand < length) & (piv[cand >> sh] <= q), cand, p)
    return p


def _warp_search(a, off: int, lo, hi, q):
    """``tg_warp_search`` for each tile: max j in [lo, hi] with a[off + j]
    <= q (lo if none); lanes 1..31 test evenly spaced points a round."""
    lanes = torch.arange(1, 32, device=q.device)
    while bool((hi > lo).any()):
        stride = (hi - lo) // 32 + 1
        pos = lo[:, None] + lanes * stride[:, None]
        le = (pos <= hi[:, None]) & (
            a[off + torch.minimum(pos, hi[:, None])] <= q[:, None])
        c = le.sum(1)
        hi = torch.minimum(hi, lo + (c + 1) * stride - 1)
        lo = lo + c * stride
    return lo


def _search(a, off: int, perm_off: Optional[int], length: int, cap: int, qt,
            span: int, levels: int):
    """``tg_search``: per probe j = min(max j' with a[off + j'] <= q, cap),
    a[off + j] and a[perm_off + j]; and which tiles staged their bracket."""
    steps = steps_for(length)
    sh = max(steps - levels, 0)
    m = torch.arange(1 << (steps - sh), device=qt.device)
    piv = a[off + torch.clamp(m << sh, max=length - 1)].long()
    qmin, qmax = qt.min(1).values, qt.max(1).values
    dlo = _pivot_descend(piv, length, steps, sh, qmin)
    dhi = _pivot_descend(piv, length, steps, sh, qmax)
    w = 1 << sh
    fits = dhi - dlo - w + 2 <= span  # else the bracket surely exceeds span
    if sh > 0 and bool(fits.any()):
        lo, hi = dlo[fits], dhi[fits]
        dlo[fits] = _warp_search(a, off, lo,
                                 torch.clamp(lo + w - 1, max=length - 1),
                                 qmin[fits])
        dhi[fits] = _warp_search(a, off, hi,
                                 torch.clamp(hi + w - 1, max=length - 1),
                                 qmax[fits])
    lo = torch.clamp(dlo, max=cap)
    width = dhi - lo + 1
    staged = fits & (width <= span)
    j, aj = torch.empty_like(qt), torch.empty_like(qt)
    pj = torch.empty_like(qt) if perm_off is not None else None
    if bool(staged.any()):
        # the staged slice a[off + lo .. off + dhi], searched in place
        st = staged
        los, qs, wd = lo[st, None], qt[st], width[st, None]
        idx = los + torch.arange(span, device=qt.device)
        sl = a[off + torch.clamp(idx, max=length - 1)].long()
        p = torch.zeros_like(qs)
        for k in range(steps_for(span) - 1, -1, -1):
            cand = p + (1 << k)
            val = torch.gather(sl, 1, torch.clamp(cand, max=span - 1))
            p = torch.where((cand < wd) & (val <= qs), cand, p)
        r = torch.clamp(los + p, max=cap) - los
        j[st] = los + r
        aj[st] = torch.gather(sl, 1, r)
        if pj is not None:
            psl = a[perm_off + torch.clamp(idx, max=cap)].long()
            pj[st] = torch.gather(psl, 1, r)
    fb = ~staged
    if bool(fb.any()):
        qf = qt[fb]
        p = _pivot_descend(piv, length, steps, sh, qf)
        for k in range(sh - 1, -1, -1):
            cand = p + (1 << k)
            val = a[off + torch.clamp(cand, max=length - 1)]
            p = torch.where((cand < length) & (val <= qf), cand, p)
        jf = torch.clamp(p, max=cap)
        j[fb], aj[fb] = jf, a[off + jf].long()
        if pj is not None:
            pj[fb] = a[perm_off + jf].long()
    return j, aj, pj, staged


def bsearch_probe_tiled(pref: torch.Tensor, q: torch.Tensor, *,
                        tile: int = THREADS * ITEMS, span: int = SPAN,
                        levels: int = LEVELS,
                        stats: Optional[Dict[str, int]] = None
                        ) -> torch.Tensor:
    """``csrc/bsearch_probe.cu``'s search as torch ops, tile by tile: equal
    to ``bsearch_probe_plain``. ``tile``, ``span`` and ``levels`` are the
    kernel's unless given (the tests shrink them); a ragged last tile
    searches its last query in the missing lanes. ``stats``, when given,
    takes the tiles and how many staged their bracket or fell back."""
    _check(pref, q)
    if not 0 <= levels <= 30 or span < 1 or tile < 1:
        raise ValueError(f"levels {levels} (0..30), span {span} and tile "
                         f"{tile} (>= 1)")
    flat = q.reshape(-1).long()
    n = flat.numel()
    if n == 0:
        return q.new_empty(q.shape)
    nt = -(-n // tile)
    qt = torch.cat([flat, flat[-1:].expand(nt * tile - n)]).reshape(nt, tile)
    np_len = pref.shape[0]
    j, _, _, staged = _search(pref, 0, None, np_len, np_len - 1, qt, span,
                              levels)
    if stats is not None:
        st = int(staged.sum())
        stats.update(tiles=nt, staged=st, fallback=nt - st)
    return j.reshape(-1)[:n].reshape(q.shape).to(torch.int32)


# ---------------------------------------------------------------------------
# The kernel's launch.
# ---------------------------------------------------------------------------

def _check(pref: torch.Tensor, q: torch.Tensor) -> None:
    if pref.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"bsearch_probe takes int32, got {pref.dtype}/{q.dtype}")
    if pref.ndim != 1 or pref.shape[0] == 0:
        raise ValueError(f"pref must be a non-empty vector, got {tuple(pref.shape)}")
    if pref.device != q.device:
        raise ValueError(f"pref on {pref.device}, q on {q.device}")


_VP = ctypes.c_void_p
_CONFIGS: Dict[int, tuple] = {}


def _config(index: int, items: int = ITEMS) -> tuple:
    """``bsearch_probe_config`` on card ``index`` (the current one), once
    per card and tile: queries a tile, blocks an SM, SMs, shared memory
    bytes."""
    cfg = _CONFIGS.get((index, items))
    if cfg is None:
        arr = (ctypes.c_int * 4)()
        build.check(build.entry("bsearch_probe", "bsearch_probe_config",
                                [_VP, ctypes.c_int])(arr, items),
                    "bsearch_probe_config")
        cfg = _CONFIGS[(index, items)] = tuple(arr)
    return cfg


def bsearch_probe_config(device=None, block_rows: Optional[int] = None
                         ) -> dict:
    """The launch shape of ``bsearch_probe`` at ``block_rows`` (``None``
    the builtin) on the card (the current one unless ``device``): the
    instance's ``block_rows`` and queries a ``tile``; a launch takes
    min(blocks an SM x SMs, tiles) blocks."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    items = items_for(block_rows)
    with build.on_device(device):
        cfg = _config(device.index, items)
    return dict(zip(("tile", "blocks_per_sm", "sms", "smem_bytes"), cfg),
                block_rows=THREADS * items // 128)


_LAUNCH_ARGS = [_VP, ctypes.c_int, ctypes.c_int, _VP, _VP, ctypes.c_longlong,
                ctypes.c_int, _VP, _VP, ctypes.c_int]


def _launch(pref: torch.Tensor, q: torch.Tensor,
            stats: Optional[Dict[str, int]], items: int = ITEMS
            ) -> torch.Tensor:
    fn = build.entry("bsearch_probe", "bsearch_probe_launch", _LAUNCH_ARGS)
    pref = pref.contiguous()
    qc = q.contiguous()
    n = qc.numel()
    dev = qc.device
    out = torch.empty_like(qc)
    counts = torch.zeros(2, dtype=torch.int32, device=dev) \
        if stats is not None else None
    with build.on_device(dev):
        tile, per_sm, sms, _ = _config(dev.index, items)
        blocks = min(per_sm * sms, -(-n // tile))
        stream = build.current_stream(dev)
        build.check(fn(pref.data_ptr(), pref.shape[0],
                       steps_for(pref.shape[0]), qc.data_ptr(),
                       out.data_ptr(), n, blocks,
                       counts.data_ptr() if counts is not None else None,
                       stream, items), "bsearch_probe")
    if counts is not None:
        staged, fallback = counts.tolist()
        stats.update(tiles=staged + fallback, staged=staged,
                     fallback=fallback)
    return out


def bsearch_probe(pref: torch.Tensor, q: torch.Tensor,
                  stats: Optional[Dict[str, int]] = None,
                  block_rows: Optional[int] = None) -> torch.Tensor:
    """pref: (NP,) int32 ascending with pref[0] == 0; q: int32, any shape.
    Returns int32 of q's shape: max j with pref[j] <= q. ``stats``, when
    given, takes the tiles that staged their bracket and that fell back
    (the kernel's own count on the card, ``bsearch_probe_tiled``'s on the
    CPU). ``block_rows`` is the tile (``None`` the builtin)."""
    _check(pref, q)
    items = items_for(block_rows)
    if q.device.type == "cpu":
        if stats is not None:
            return bsearch_probe_tiled(pref, q, tile=THREADS * items,
                                       stats=stats)
        return bsearch_probe_plain(pref, q)
    if q.device.type != "cuda":
        raise ValueError(f"bsearch_probe: unsupported device {q.device}")
    out = _launch(pref, q, stats, items)
    bsearch_probe.launches += 1
    count_tile(bsearch_probe, f"block_rows={THREADS * items // 128}")
    return out


bsearch_probe.launches = 0
bsearch_probe.tiles = {}


def out_of_bounds(pref: torch.Tensor, q: torch.Tensor,
                  block_rows: Optional[int] = None, stats: bool = False
                  ) -> dict:
    """One launch of the checked build (``bsearch_probe_checked``,
    ``-DBP_CHECK_BOUNDS``) at ``block_rows`` (``None`` the builtin), with
    the production build's grid for it (``bsearch_probe_config``), every
    load and store held against the prefix vector, the queries, the
    answers and (``stats``) the tile counts: ``build.checked_run``'s count
    and records, with the answers ``out``. Raises off the card."""
    _check(pref, q)
    items = items_for(block_rows)
    pref, qc = pref.contiguous(), q.contiguous()
    n = qc.numel()
    dev = qc.device
    if dev.type != "cuda":
        raise ValueError(f"out_of_bounds: the checked build runs on the "
                         f"card, not on {dev}")
    out = torch.empty_like(qc)
    counts = torch.zeros(2, dtype=torch.int32, device=dev) if stats else None
    with build.on_device(dev):
        tile, per_sm, sms, _ = _config(dev.index, items)
    blocks = min(per_sm * sms, -(-n // tile))
    lib = "bsearch_probe_checked"
    fn = build.entry(lib, "bsearch_probe_launch", _LAUNCH_ARGS)

    def launch(stream):
        build.check(fn(pref.data_ptr(), pref.shape[0],
                       steps_for(pref.shape[0]), qc.data_ptr(),
                       out.data_ptr(), n, blocks,
                       counts.data_ptr() if counts is not None else None,
                       stream, items), "bsearch_probe (checked)")

    found = build.bounds_check(lib, launch, (
        ("pref", pref), ("q", qc), ("out", out), ("stats", counts)), dev)
    return dict(found, out=out)
