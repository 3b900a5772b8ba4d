"""One launch from a Threefry key to compacted sample rows.

``fused_draw`` launches ``csrc/fused_draw.cu`` (one cooperative launch
over the whole card) for CUDA tensors; for CPU tensors it runs
``fused_draw_plain``: ``draw_core`` (the sort-free EXPRACE) plus
``tree_walk``. ``fused_sample`` is the same launch without the walk (the
paged draw's front end; its plain version is ``draw_core``): one kernel
body serves both, so their positions are bit-equal under one key.
``fused_draw_batch`` and ``fused_sample_batch`` run the same kernel for B
keys in one launch (the reference vmaps its launch over the keys); no
step mixes two keys, so lane b is bit-equal to the single launch under
key b, and their plain versions are the single plain versions per key.
Each wrapper's ``launches`` counts its kernel launches.

The kernel runs every search of the draw by tiles of ascending queries
(the design is in ``csrc/fused_draw.cu``): a tile brackets its used
queries' counts, stages the slice in shared memory when it is at most
``SPAN`` words wide and otherwise descends lane by lane within the
bracket, and walks its output positions with the GET's tile walk.
``fused_draw_tiled`` spells that logic out as torch ops (the tests run it
at small tiles and spans), and ``tile_stats`` returns the kernel's own
count of staged and fallback tile searches, which equals the model's.

EXPRACE, sort-free: iid Exp(1) gaps are prefix-summed, so the running sum
is a unit-rate Poisson process on [0, Lam) and arrivals come out already
ascending. Cell placement, dedupe, per-root success counts and the
l-th-missing-value complement inversion (p > 1/2) are branchless binary
searches (``_count_le``) over sorted vectors. The stages mirror the
reference's ``_exprace_core`` step for step.

The float32 arrival sum is the one order-sensitive step. Its order is
``prefix_sum.scan_order`` at tiles of ``THREADS * ITEMS`` (a thread's
items in sequence; thread totals Hillis-Steele; tile carries the same
scan over the tile totals), fixed constants that do not depend on the
kernel's grid, so the kernel and the plain version agree bit for bit on
the card. A running max follows the sum (see ``arrivals``); the integer
running counts are exact in any order. Against the reference (whose
cumsum XLA orders its own way) an arrival may land in the neighbouring
cell when it lies within a few float32 ulp of a cell boundary.

Flat PTBERN (``method='ptbern_flat'``): one Threefry trial of stream 1
per flat position, a running count, and a binary-search compaction — all
integer after the uniform, so it matches the reference exactly.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import threefry
from .prefix_sum import scan_order
from .tree_probe import _ctable, tree_walk, tree_walk_tiled

__all__ = ["PARAM_ORDER", "THREADS", "ITEMS", "draw_core", "arrivals",
           "fused_draw_plain", "fused_draw", "fused_sample_plain",
           "fused_sample", "fused_draw_batch_plain", "fused_draw_batch",
           "fused_sample_batch_plain", "fused_sample_batch", "TILE", "SPAN",
           "fused_draw_tiled", "fused_draw_batch_tiled", "grid", "PHASES",
           "phase_ms", "tile_stats", "scratch_bytes", "out_of_bounds",
           "CHECK_RECORDS"]

I32 = torch.int32
F32 = torch.float32
_TINY = 1e-12
# Operand order of the plan-bound parameter vectors
# (sampling.fused_draw_params).
PARAM_ORDER = ("massE", "lam", "sign", "w32", "prefE32", "cwE", "offE", "p32")
THREADS = 256  # FD_THREADS in csrc/fused_draw.cu
ITEMS = 4      # FD_ITEMS: tiles of 1,024 lanes


def _count_le(vec: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """#elements of the ascending ``vec`` that are <= q (branchless
    power-of-two descent; values in [0, len(vec)])."""
    L = vec.shape[0]
    p = torch.zeros(q.shape, dtype=I32, device=q.device)
    for k in range(max(1, L.bit_length()) - 1, -1, -1):
        cand = p + (1 << k)
        val = vec[torch.clamp(cand, max=L) - 1]
        p = torch.where((cand <= L) & (val <= q), cand, p)
    return p


def arrivals(key, acap: int, device) -> torch.Tensor:
    """The float32 arrival times: the running sum of ``-log1p(-u)`` over
    ``acap`` Threefry uniforms of stream 0 in the kernel's order, then its
    running max. The sum's tile order can round an element an ulp below
    its predecessor after a tiny gap (at a thread or tile boundary); the
    max keeps the arrivals ascending, as the draw needs, and is exact in
    any order."""
    u = threefry.uniforms_plain(key, acap, stream=0, device=device)
    gaps = -torch.log1p(-u)
    return torch.cummax(scan_order(gaps, THREADS, ITEMS), 0).values


def _exprace_core(key, params, acap: int, cap: int):
    """Sorted-gap EXPRACE: key -> (positions, count, overflow), int32 and
    float32 throughout, no sort and no scatter."""
    massE, lam, sign = params["massE"], params["lam"], params["sign"]
    w32, prefE32 = params["w32"], params["prefE32"]
    cwE, offE = params["cwE"], params["offE"]
    dev = massE.device
    R = w32.shape[0]
    n32 = prefE32[R]

    # --- arrivals: cumsum of Exp(1) gaps == unit-rate Poisson process ------
    v = arrivals(key, acap, dev)
    Lam = massE[R]
    avalid = v < Lam
    more_arrivals = avalid[acap - 1]

    # --- cell placement (inverse CDF into the mass prefix) -----------------
    r = torch.clamp(_count_le(massE, v) - 1, 0, R - 1)
    x = (v - massE[r]) / torch.clamp(lam[r], min=_TINY)
    cell = torch.floor(x).to(I32)
    cell = torch.minimum(torch.clamp(cell, min=0),
                         torch.clamp(w32[r] - 1, min=0))
    gid = torch.where(avalid, prefE32[r] + cell, n32)

    # --- dedupe (>=1 arrival == one success/failure) -----------------------
    prev = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), gid[:-1]])
    uniq = (gid < n32) & (gid != prev)
    seg = torch.clamp(_count_le(prefE32, gid) - 1, 0, R - 1)
    U = torch.cumsum(uniq.to(I32), 0, dtype=I32)
    S = torch.cumsum(torch.where(uniq, sign[seg], 0).to(I32), 0, dtype=I32)

    # --- per-root output prefix, via boundary counts -----------------------
    B = _count_le(gid, prefE32 - 1)
    Bm1 = torch.clamp(B - 1, min=0)
    SB = torch.where(B > 0, S[Bm1], 0)
    UB = torch.where(B > 0, U[Bm1], 0)
    outE = (cwE + SB).to(I32)
    hitsE = UB.to(I32)
    K = outE[R]

    # --- complement support: carry-forward g-values ------------------------
    local = gid - prefE32[seg]
    lrank = (U - 1) - hitsE[seg]
    gval = local - lrank + offE[seg]
    gc = torch.cummax(torch.where(uniq, gval, -(1 << 30)).to(I32), 0).values

    # --- emit output slots (gather-only compaction) ------------------------
    t = torch.arange(cap, dtype=I32, device=dev)
    rO = torch.clamp(_count_le(outE, t) - 1, 0, R - 1)
    l = t - outE[rO]
    wm1 = torch.clamp(w32[rO] - 1, min=0)
    hO = hitsE[rO]
    i_star = torch.clamp(_count_le(U, hO + l), max=acap - 1)
    direct_local = gid[i_star] - prefE32[rO]
    Lq = _count_le(gc, l + offE[rO])
    c = torch.where(Lq > 0, U[torch.clamp(Lq - 1, min=0)], 0) - hO
    comp_pos = l + torch.minimum(torch.clamp(c, min=0), wm1 - l + 1)
    local_out = torch.where(sign[rO] < 0, comp_pos, direct_local)
    pos = prefE32[rO] + torch.minimum(torch.clamp(local_out, min=0), wm1)
    count = torch.clamp(K, max=cap)
    positions = torch.where(t < count, pos, n32).to(I32)
    overflow = more_arrivals | (K > cap)
    return positions, count.to(I32), overflow


def _ptbern_core(key, params, n: int, cap: int):
    """Flat PTBERN: one Bernoulli trial per flat position (n lanes; the
    route gate keeps n within the draw budget), success compaction by a
    running-count binary search."""
    prefE32, p32 = params["prefE32"], params["p32"]
    dev = p32.device
    R = p32.shape[0]
    n32 = prefE32[R]
    u = threefry.uniforms_plain(key, n, stream=1, device=dev)
    flat = torch.arange(n, dtype=I32, device=dev)
    r = torch.clamp(_count_le(prefE32, flat) - 1, 0, R - 1)
    C = torch.cumsum((u < p32[r]).to(I32), 0, dtype=I32)
    total = C[n - 1]
    t = torch.arange(cap, dtype=I32, device=dev)
    pos = torch.clamp(_count_le(C, t), max=n - 1)  # first lane with C == t+1
    count = torch.clamp(total, max=cap)
    positions = torch.where(t < count, pos, n32).to(I32)
    return positions, count.to(I32), total > cap


def draw_core(key, params, *, method: str, cap: int, acap: int = 0,
              n: int = 0):
    """Sample positions: ``(positions (cap,) i32, count () i32, overflow
    () bool)``, positions ascending over valid lanes, sentinel n beyond."""
    if method == "exprace":
        return _exprace_core(key, params, acap, cap)
    if method == "ptbern_flat":
        return _ptbern_core(key, params, n, cap)
    raise ValueError(f"unknown fused draw method {method!r}")


def fused_draw_plain(arena, key, params, *, layout, method: str, cap: int,
                     acap: int = 0, n: int = 0):
    """``draw_core`` then the walk of every position, as torch ops."""
    positions, count, overflow = draw_core(key, params, method=method,
                                           cap=cap, acap=acap, n=n)
    wpos = torch.clamp(positions, max=params["prefE32"][-1] - 1)
    rows = torch.stack(tree_walk(arena, wpos, layout))
    return rows, positions, count, overflow


def fused_draw_batch_plain(arena, keys, params, *, layout, method: str,
                           cap: int, acap: int = 0, n: int = 0):
    """``fused_draw_plain`` under each key, stacked: the batched kernel's
    plain version."""
    out = [fused_draw_plain(arena, k, params, layout=layout, method=method,
                            cap=cap, acap=acap, n=n)
           for k in threefry.key_batch(keys)]
    return tuple(torch.stack(x) for x in zip(*out))


def fused_sample_batch_plain(keys, params, *, method: str, cap: int,
                             acap: int = 0, n: int = 0):
    """``draw_core`` under each key, stacked."""
    out = [draw_core(k, params, method=method, cap=cap, acap=acap, n=n)
           for k in threefry.key_batch(keys)]
    return tuple(torch.stack(x) for x in zip(*out))


# ---------------------------------------------------------------------------
# The kernel's tile searches as torch ops (the plain model of
# csrc/fused_draw.cu's searches): every search of the draw runs by tiles of
# ``tile`` consecutive lanes of one key. A tile brackets the counts of its
# used queries' min and max; where the slice x[max(lo - 1, 0), hi) is at
# most ``span`` wide it is staged and searched there, else each used lane
# descends within [lo, hi] in device memory. Unused lanes (padding, the
# other kind of root) are left out of the bracket. Equal to the plain
# searches for any queries.
# ---------------------------------------------------------------------------

TILE = THREADS * ITEMS  # FD_TILE: lanes of a work item
SPAN = 3584             # FD_SPAN: the widest slice a tile search stages


def _count_tiled(vec, q, use, tile: int, span: int, stats) -> torch.Tensor:
    """count_le(vec, q) (``_count_le``) for every used lane of ``q``, tile
    by tile as the kernel searches; an unused lane gets its tile's low
    bracket end. ``stats`` counts tiles that staged or fell back."""
    L, n = vec.shape[0], q.shape[0]
    nt = -(-n // tile)
    fl = vec.is_floating_point()
    qt = torch.cat([q if fl else q.long(),
                    q.new_zeros(nt * tile - n, dtype=q.dtype if fl else
                                torch.int64)]).reshape(nt, tile)
    ut = torch.cat([use, use.new_zeros(nt * tile - n)]).reshape(nt, tile)
    top = float("inf") if fl else 1 << 62
    qlo = torch.where(ut, qt, top).min(1).values
    qhi = torch.where(ut, qt, -top).max(1).values
    some = ut.any(1)
    zero = torch.zeros(nt, dtype=torch.int64, device=q.device)
    lo = torch.where(some, _count_le(vec, qlo).long(), zero)
    hi = torch.where(some, _count_le(vec, qhi).long(), zero)
    s0 = torch.clamp(lo - 1, min=0)
    staged = some & (hi - s0 <= span)
    out = lo[:, None].expand(nt, tile).clone()
    width = (hi - lo)[:, None]
    for mask, local in ((staged, True), (some & ~staged, False)):
        if not bool(mask.any()):
            continue
        lo_m, w_m, q_m = lo[mask, None], width[mask], qt[mask]
        if local:  # the staged slice x[s0, s0 + span], searched in place
            sl = vec[torch.clamp(s0[mask, None] + torch.arange(
                span + 1, device=q.device), max=L - 1)]
            off = lo_m - s0[mask, None]
        p = torch.zeros_like(q_m, dtype=torch.int64)
        for k in range(max(int(w_m.max()), 1).bit_length() - 1, -1, -1):
            cand = p + (1 << k)
            at = torch.clamp(torch.minimum(cand, w_m) - 1, min=0)
            val = (torch.gather(sl, 1, off + at) if local
                   else vec[torch.clamp(lo_m + at, max=L - 1)])
            p = torch.where((cand <= w_m) & (val <= q_m), cand, p)
        out[mask] = lo_m + p
    if stats is not None:
        stats["staged"] = stats.get("staged", 0) + int(staged.sum())
        stats["fallback"] = stats.get("fallback", 0) + int(
            (some & ~staged).sum())
    out = torch.where(ut, out, lo[:, None])
    return out.reshape(-1)[:n].to(I32)


def _exprace_tiled(key, params, acap: int, cap: int, tile: int, span: int,
                   stats):
    """``_exprace_core`` with every search by tiles, in the kernel's
    phases: cells (the mass prefix; a unique arrival's root segment is the
    root its cell was placed in, so no search of the root prefix), root
    boundaries (the cells), the output prefix, then hit ranks (U) and
    complement ranks (gc)."""
    massE, lam, sign = params["massE"], params["lam"], params["sign"]
    w32, prefE32 = params["w32"], params["prefE32"]
    cwE, offE = params["cwE"], params["offE"]
    dev = massE.device
    R = w32.shape[0]
    n32 = prefE32[R]

    def count(vec, qv, use):
        return _count_tiled(vec, qv, use, tile, span, stats)

    v = arrivals(key, acap, dev)
    Lam = massE[R]
    avalid = v < Lam
    every = torch.ones(acap, dtype=torch.bool, device=dev)
    r = torch.clamp(count(massE, v, every) - 1, 0, R - 1)
    x = (v - massE[r]) / torch.clamp(lam[r], min=_TINY)
    cell = torch.minimum(torch.clamp(torch.floor(x).to(I32), min=0),
                         torch.clamp(w32[r] - 1, min=0))
    gid = torch.where(avalid, prefE32[r] + cell, n32)
    prev = torch.cat([torch.full((1,), -1, dtype=I32, device=dev), gid[:-1]])
    uniq = (gid < n32) & (gid != prev)
    U = torch.cumsum(uniq.to(I32), 0, dtype=I32)
    S = torch.cumsum(torch.where(uniq, sign[r], 0).to(I32), 0, dtype=I32)
    B = count(gid, prefE32 - 1, torch.ones(R + 1, dtype=torch.bool,
                                           device=dev))
    Bm1 = torch.clamp(B - 1, min=0)
    outE = (cwE + torch.where(B > 0, S[Bm1], 0)).to(I32)
    hitsE = torch.where(B > 0, U[Bm1], 0).to(I32)
    K = outE[R]
    gval = (gid - prefE32[r]) - ((U - 1) - hitsE[r]) + offE[r]
    gc = torch.cummax(torch.where(uniq, gval, -(1 << 30)).to(I32), 0).values
    t = torch.arange(cap, dtype=I32, device=dev)
    valid = t < torch.clamp(K, max=cap)
    rO = torch.clamp(count(outE, t, valid) - 1, 0, R - 1)
    l = t - outE[rO]
    wm1 = torch.clamp(w32[rO] - 1, min=0)
    hO = hitsE[rO]
    comp = sign[rO] < 0
    i_star = torch.clamp(count(U, hO + l, valid & ~comp), max=acap - 1)
    Lq = count(gc, l + offE[rO], valid & comp)
    direct_local = gid[i_star] - prefE32[rO]
    c = torch.where(Lq > 0, U[torch.clamp(Lq - 1, min=0)], 0) - hO
    comp_pos = l + torch.minimum(torch.clamp(c, min=0), wm1 - l + 1)
    local_out = torch.where(comp, comp_pos, direct_local)
    pos = prefE32[rO] + torch.minimum(torch.clamp(local_out, min=0), wm1)
    count_k = torch.clamp(K, max=cap)
    positions = torch.where(valid, pos, n32).to(I32)
    return positions, count_k.to(I32), avalid[acap - 1] | (K > cap)


def _ptbern_tiled(key, params, n: int, cap: int, tile: int, span: int,
                  stats):
    """``_ptbern_core`` with its two searches by tiles: the root prefix of
    every flat position, then the output lanes into the running count."""
    prefE32, p32 = params["prefE32"], params["p32"]
    dev = p32.device
    R = p32.shape[0]
    n32 = prefE32[R]
    u = threefry.uniforms_plain(key, n, stream=1, device=dev)
    flat = torch.arange(n, dtype=I32, device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    r = torch.clamp(_count_tiled(prefE32, flat, every, tile, span, stats) - 1,
                    0, R - 1)
    C = torch.cumsum((u < p32[r]).to(I32), 0, dtype=I32)
    total = C[n - 1]
    t = torch.arange(cap, dtype=I32, device=dev)
    count = torch.clamp(total, max=cap)
    pos = torch.clamp(_count_tiled(C, t, t < count, tile, span, stats),
                      max=n - 1)
    return torch.where(t < count, pos, n32).to(I32), count.to(I32), total > cap


def fused_draw_tiled(arena, key, params, *, layout=None, method: str,
                     cap: int, acap: int = 0, n: int = 0, tile: int = TILE,
                     span: int = SPAN, stats: Optional[dict] = None):
    """``csrc/fused_draw.cu``'s searches and walk as torch ops, tile by
    tile: equal to ``fused_draw_plain`` (``arena`` None: to ``draw_core``,
    the ``fused_sample`` instance). ``tile`` and ``span`` are the kernel's
    unless given (the tests shrink them). The walk goes by output tiles as
    the kernel's does: valid lanes walk their positions, the padding lanes
    of a tile its largest valid position, and then take the rows of
    position n32 - 1; it is ``tree_probe.tree_walk_tiled`` on those
    queries. ``stats``, when given, takes the draw's tile searches that
    staged and fell back (the kernel's ``tile_stats``)."""
    if method == "exprace":
        out = _exprace_tiled(key, params, acap, cap, tile, span, stats)
    elif method == "ptbern_flat":
        out = _ptbern_tiled(key, params, n, cap, tile, span, stats)
    else:
        raise ValueError(f"unknown fused draw method {method!r}")
    if arena is None:
        return out
    positions, count, _ = out
    n32 = params["prefE32"][-1]
    nt = -(-cap // tile)
    pt = torch.cat([positions, positions.new_full((nt * tile - cap,), n32)])
    pt = pt.reshape(nt, tile)
    valid = (torch.arange(nt * tile, device=pt.device) < count).reshape(nt,
                                                                        tile)
    top = torch.where(valid, pt, -1).max(1, keepdim=True).values
    q = torch.where(valid, torch.clamp(pt, max=n32 - 1),
                    torch.where(top >= 0, top, n32 - 1))
    rows = torch.stack(tree_walk_tiled(arena, q.reshape(-1)[:cap], layout))
    pad = torch.stack(tree_walk(arena, (n32 - 1).reshape(1), layout))
    rows = torch.where(valid.reshape(-1)[:cap], rows, pad)
    return (rows, *out)


def fused_draw_batch_tiled(arena, keys, params, *, layout=None, method: str,
                           cap: int, acap: int = 0, n: int = 0,
                           tile: int = TILE, span: int = SPAN,
                           stats: Optional[dict] = None):
    """``fused_draw_tiled`` under each of the (B, 2) ``keys``, stacked (the
    batched kernels' model: no search mixes two keys); ``stats`` sums the
    keys' tile searches."""
    out = []
    for k in threefry.key_batch(keys):
        st = {} if stats is not None else None
        out.append(fused_draw_tiled(arena, k, params, layout=layout,
                                    method=method, cap=cap, acap=acap, n=n,
                                    tile=tile, span=span, stats=st))
        if st is not None:
            for name in ("staged", "fallback"):
                stats[name] = stats.get(name, 0) + st.get(name, 0)
    return tuple(torch.stack(x) for x in zip(*out))


_METHODS = {"exprace": 0, "ptbern_flat": 1}  # FD_EXPRACE / FD_PTBERN
_ENTRIES = {}
CHECK_RECORDS = 64  # FD_CHECK_RECORDS: the loads a checked launch keeps


def _entry(name: str, lib: str = "fused_draw"):
    """``<name>`` of the build ``lib`` of ``csrc/fused_draw.cu`` (or of its
    checked build, ``fused_draw_checked``) with its argument types, set
    once."""
    fn = _ENTRIES.get((lib, name))
    if fn is None:
        from . import build

        fn = getattr(build.library(lib), name)
        vp, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        draw = [vp, i32, u32, u32, i32] + [vp] * 8 + [i32] * 3
        fn.argtypes = {
            "fused_draw_launch": [vp, vp] + draw + [vp] * 7,
            "fused_sample_launch": draw + [vp] * 6,
            "fused_draw_scratch_words": [i32] * 3,
            "fused_draw_grid": [i32] * 5 + [vp, vp],
            "fused_draw_check_set": [vp, vp, i32],
            "fused_draw_check_get": [vp, vp],
        }[name]
        fn.restype = (ctypes.c_longlong if name == "fused_draw_scratch_words"
                      else ctypes.c_int)
        _ENTRIES[(lib, name)] = fn
    return fn


def scratch_bytes(lanes: int, R: int, batch: int = 1) -> int:
    """Bytes of one launch's scratch on the card: ``batch`` slabs of
    ``lanes`` lanes and ``R`` roots, the look-back words and the barrier
    counter (``fused_draw_scratch_words``)."""
    return 4 * int(_entry("fused_draw_scratch_words")(lanes, R, batch))


def grid(walk: bool, lanes: int, cap: int, R: int, batch: int = 1,
         layout=None):
    """``(blocks a multiprocessor holds, multiprocessors, blocks of the
    launch, dynamic shared memory bytes)`` of the cooperative draw at these
    sizes on the current card (``walk``: the ``fused_draw`` instance for
    ``layout``, else ``fused_sample``'s)."""
    from . import build

    if walk and layout is None:
        raise ValueError("the walk's grid needs its layout")
    table = _ctable(layout, None) if walk else None
    out = (ctypes.c_int * 4)()
    build.check(_entry("fused_draw_grid")(int(walk), lanes, cap, R, batch,
                                          table, out), "fused_draw_grid")
    return tuple(out)


def _device_keys(keys, dev) -> torch.Tensor:
    """(B, 2) key words as an int32 tensor on ``dev`` (the bits of the
    uint32 words), copied from page-locked host memory without a wait: a
    copy from pageable memory would hold the host until the card had
    finished the work before it."""
    words = threefry.key_batch(keys)
    return torch.from_numpy(words.view(np.int32)).pin_memory().to(
        dev, non_blocking=True)


def _launch(entry: str, arena, key, params, layout, method: str, cap: int,
            acap: int, n: int, keys=None, stamps=None, stats=None,
            check=None):
    """Launch ``fused_draw_launch`` (with ``arena``) or
    ``fused_sample_launch`` (``arena`` None) on the params' device: one
    cooperative launch over the card for the one ``key``, or for the (B, 2)
    ``keys`` (``key`` None), its scratch one allocation. ``stamps``
    (zeroed int64, or None) takes the kernel's phase clock, ``stats`` (two
    zeroed int64, or None) its staged and fallback tile searches. With
    ``check`` (a dict) the checked build runs instead and ``check`` takes
    its loads outside the operands (``_checked_run``). Returns
    ``(rows (B, slots, cap) or None, positions (B, cap), scalars (B, 2))``,
    B = 1 for one key; raises if the kernel cannot be built or launched (a
    refused cooperative launch included)."""
    dev = params["prefE32"].device
    if dev.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {dev}")
    if method not in _METHODS:
        raise ValueError(f"unknown fused draw method {method!r}")
    lanes = acap if method == "exprace" else n
    if lanes < 1 or cap < 1:
        raise ValueError(f"{method}: lanes={lanes} and cap={cap} must be "
                         "positive")
    ops = [params[k].contiguous() for k in PARAM_ORDER]
    for name, t in zip(PARAM_ORDER, ops):
        want = F32 if name in ("massE", "lam", "p32") else I32
        if t.dtype != want or t.device != dev:
            raise TypeError(f"param {name}: {t.dtype} on {t.device}")
    from . import build

    fn = _entry(f"{entry}_launch")
    R = ops[3].shape[0]
    if keys is None:
        batch, kptr = 1, None
        k0, k1 = threefry.key_words(key)
    else:
        kdev = _device_keys(keys, dev)
        batch, kptr, k0, k1 = kdev.shape[0], kdev.data_ptr(), 0, 0
        if batch < 1:
            raise ValueError(f"{entry}: a batch needs at least one key")
    rows = None
    args = []
    if arena is not None:
        if arena.device != dev:
            raise ValueError(f"arena on {arena.device}, params on {dev}")
        rows = torch.empty((batch, layout.num_slots, cap), dtype=I32,
                           device=dev)
        args = [arena.contiguous().data_ptr(), _ctable(layout, None)]
    positions = torch.empty((batch, cap), dtype=I32, device=dev)
    scalars = torch.empty((batch, 2), dtype=I32, device=dev)
    scratch = torch.empty(
        (_entry("fused_draw_scratch_words")(lanes, R, batch),),
        dtype=I32, device=dev)
    args += [kptr, batch, k0, k1, _METHODS[method],
             *[t.data_ptr() for t in ops], R, lanes, cap]
    if rows is not None:
        args.append(rows.data_ptr())
    args += [positions.data_ptr(), scalars.data_ptr(), scratch.data_ptr(),
             None if stamps is None else stamps.data_ptr(),
             None if stats is None else stats.data_ptr()]
    if check is not None:
        operands = [("arena", arena), *zip(PARAM_ORDER, ops), ("rows", rows),
                    ("positions", positions), ("scalars", scalars),
                    ("scratch", scratch),
                    ("keys", None if keys is None else kdev),
                    ("stamps", stamps), ("stats", stats)]
        _checked_run(entry, args, dev, operands, check)
        return rows, positions, scalars
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(fn(*args, stream), entry)
    return rows, positions, scalars


def _checked_run(entry: str, args, dev, operands, check: dict) -> None:
    """One launch of ``entry`` from the checked build, its loads held
    against the byte ranges of ``operands`` (``build.checked_run``);
    ``check`` takes its ``count`` and ``loads``."""
    from . import build

    lib = "fused_draw_checked"
    check.update(build.checked_run(
        _entry("fused_draw_check_set", lib),
        lambda stream: build.check(_entry(f"{entry}_launch", lib)(*args,
                                                                  stream),
                                   entry),
        _entry("fused_draw_check_get", lib), operands, dev, CHECK_RECORDS))


# The kernel's phases, in order (csrc/fused_draw.cu), for phase_ms; the
# fused_sample instance has no walk.
PHASES = {
    "exprace": ("gaps and tile sums", "tile carries (one block a key)",
                "arrivals, cells and counts (look-back)", "root prefixes",
                "complement max (look-back)",
                "output slots", "walk"),
    "ptbern_flat": ("trials and counts (look-back)", "output slots", "walk"),
}


def phase_ms(arena, key, params, *, layout=None, method: str, cap: int,
             acap: int = 0, n: int = 0, keys=None) -> dict:
    """Milliseconds of each phase of one launch on the card, by the global
    clock: block 0 reads it at the start and after each grid barrier, and
    the last phase ends when the last block does. ``arena`` None times the
    ``fused_sample`` instance; ``keys`` (B, 2), with ``key`` None, times
    the batched launch. A measurement: it is not counted in ``launches``."""
    dev = params["prefE32"].device
    names = PHASES[method][:-1] if arena is None else PHASES[method]
    stamps = torch.zeros((len(names) + 1,), dtype=torch.int64, device=dev)
    _launch("fused_sample" if arena is None else "fused_draw", arena, key,
            params, layout, method, cap, acap, n, keys=keys, stamps=stamps)
    t = stamps.cpu().tolist()
    return {name: (b - a) / 1e6 for name, a, b in zip(names, t, t[1:])}


def tile_stats(arena, key, params, *, layout=None, method: str, cap: int,
               acap: int = 0, n: int = 0, keys=None) -> dict:
    """The tile searches of one launch on the card: ``{"staged": ...,
    "fallback": ...}``, searches whose bracket fit ``SPAN`` and was staged
    in shared memory, and those that fell back to a per-lane descent (the
    draw's own searches; the walk's are ``tree_get``'s). Arguments as
    ``phase_ms``. A measurement: it is not counted in ``launches``."""
    dev = params["prefE32"].device
    stats = torch.zeros((2,), dtype=torch.int64, device=dev)
    _launch("fused_sample" if arena is None else "fused_draw", arena, key,
            params, layout, method, cap, acap, n, keys=keys, stats=stats)
    staged, fallback = stats.cpu().tolist()
    return {"staged": staged, "fallback": fallback}


def out_of_bounds(arena, key, params, *, layout=None, method: str,
                  cap: int, acap: int = 0, n: int = 0, keys=None) -> dict:
    """The loads of one launch that fall outside its operands, by the
    checked build of the kernel (``build.VARIANTS``, ``FD_CHECK_BOUNDS``):
    ``{"count": ..., "loads": [(source line, operand, byte offset, the
    operand's bytes, load bytes), ...], "out": (rows, positions,
    scalars)}``, the first ``CHECK_RECORDS`` loads recorded (rows None for
    the draw without the walk). Arguments as ``phase_ms``. A measurement:
    it is not counted in ``launches``."""
    check: dict = {}
    out = _launch("fused_sample" if arena is None else "fused_draw", arena,
                  key, params, layout, method, cap, acap, n, keys=keys,
                  check=check)
    return dict(check, out=out)


def fused_draw(arena, key, params, *, layout, method: str, cap: int,
               acap: int = 0, n: int = 0):
    """The one-launch draw. arena: (layout.size,) int32; key: two uint32
    words; params: the ``sampling.fused_draw_params`` dict; ``acap`` the
    arrival scratch of EXPRACE, ``n`` the join size (flat PTBERN's lanes).
    Returns ``(rows (num_slots, cap) i32, positions (cap,) i32, count ()
    i32, overflow () bool)``, rows in ``layout.names`` slot order."""
    if arena.device.type == "cpu":
        return fused_draw_plain(arena, key, params, layout=layout,
                                method=method, cap=cap, acap=acap, n=n)
    rows, positions, scalars = _launch("fused_draw", arena, key, params,
                                       layout, method, cap, acap, n)
    fused_draw.launches += 1
    return rows[0], positions[0], scalars[0, 0], scalars[0, 1].to(torch.bool)


fused_draw.launches = 0


def fused_draw_batch(arena, keys, params, *, layout, method: str, cap: int,
                     acap: int = 0, n: int = 0):
    """``fused_draw`` under B keys in one launch. keys: (B, 2) uint32 words
    (``threefry.keys``, a numpy array or a tensor). Returns ``(rows (B,
    num_slots, cap) i32, positions (B, cap) i32, count (B,) i32, overflow
    (B,) bool)``; lane b equals ``fused_draw`` under ``keys[b]``."""
    if arena.device.type == "cpu":
        return fused_draw_batch_plain(arena, keys, params, layout=layout,
                                      method=method, cap=cap, acap=acap, n=n)
    rows, positions, scalars = _launch("fused_draw", arena, None, params,
                                       layout, method, cap, acap, n,
                                       keys=keys)
    fused_draw_batch.launches += 1
    return rows, positions, scalars[:, 0], scalars[:, 1].to(torch.bool)


fused_draw_batch.launches = 0


def fused_sample_plain(key, params, *, method: str, cap: int, acap: int = 0,
                       n: int = 0):
    """``fused_sample``'s plain version: ``draw_core`` itself."""
    return draw_core(key, params, method=method, cap=cap, acap=acap, n=n)


def fused_sample(key, params, *, method: str, cap: int, acap: int = 0,
                 n: int = 0):
    """The draw without the walk, in one launch: key -> ``(positions
    (cap,) i32, count () i32, overflow () bool)`` with the same
    conventions as ``draw_core``, on the params' device. It reads only the
    root-level parameter vectors, never the arena."""
    if params["prefE32"].device.type == "cpu":
        return fused_sample_plain(key, params, method=method, cap=cap,
                                  acap=acap, n=n)
    _, positions, scalars = _launch("fused_sample", None, key, params, None,
                                    method, cap, acap, n)
    fused_sample.launches += 1
    return positions[0], scalars[0, 0], scalars[0, 1].to(torch.bool)


fused_sample.launches = 0


def fused_sample_batch(keys, params, *, method: str, cap: int, acap: int = 0,
                       n: int = 0):
    """``fused_sample`` under B keys in one launch: ``(positions (B, cap)
    i32, count (B,) i32, overflow (B,) bool)``; lane b equals
    ``fused_sample`` under ``keys[b]``."""
    if params["prefE32"].device.type == "cpu":
        return fused_sample_batch_plain(keys, params, method=method, cap=cap,
                                        acap=acap, n=n)
    _, positions, scalars = _launch("fused_sample", None, None, params, None,
                                    method, cap, acap, n, keys=keys)
    fused_sample_batch.launches += 1
    return positions, scalars[:, 0], scalars[:, 1].to(torch.bool)


fused_sample_batch.launches = 0
