"""One launch from a Threefry key to compacted sample rows.

``fused_draw`` launches ``csrc/fused_draw.cu`` (one block) for CUDA
tensors; for CPU tensors it runs ``fused_draw_plain``: ``draw_core`` (the
sort-free EXPRACE) plus ``tree_walk``. ``fused_sample`` is the same
launch without the walk (the paged draw's front end; its plain version
is ``draw_core``): one kernel body serves both, so their positions are
bit-equal under one key. Each wrapper's ``launches`` counts its kernel
launches.

EXPRACE, sort-free: iid Exp(1) gaps are prefix-summed, so the running sum
is a unit-rate Poisson process on [0, Lam) and arrivals come out already
ascending. Cell placement, dedupe, per-root success counts and the
l-th-missing-value complement inversion (p > 1/2) are branchless binary
searches (``_count_le``) over sorted vectors. The stages mirror the
reference's ``_exprace_core`` step for step.

The float32 arrival sum is the one order-sensitive step. ``_scan_f32``
spells out the kernel's order (chunks of ``THREADS * ITEMS``; a thread's
items in sequence; thread totals Hillis-Steele; carry + (exclusive thread
prefix + local prefix)), so the kernel and the plain version agree bit for
bit on the card. A running max follows the sum (see ``arrivals``). Against the reference (whose cumsum XLA orders its own
way) an arrival may land in the neighbouring cell when it lies within a
few float32 ulp of a cell boundary.

Flat PTBERN (``method='ptbern_flat'``): one Threefry trial of stream 1
per flat position, a running count, and a binary-search compaction — all
integer after the uniform, so it matches the reference exactly.
"""
from __future__ import annotations

import ctypes

import torch

from . import threefry
from .tree_probe import layout_table, tree_walk

__all__ = ["PARAM_ORDER", "THREADS", "ITEMS", "draw_core", "arrivals",
           "fused_draw_plain", "fused_draw", "fused_sample_plain",
           "fused_sample"]

I32 = torch.int32
F32 = torch.float32
_TINY = 1e-12
# Operand order of the plan-bound parameter vectors
# (sampling.fused_draw_params).
PARAM_ORDER = ("massE", "lam", "sign", "w32", "prefE32", "cwE", "offE", "p32")
THREADS = 1024  # FD_THREADS in csrc/fused_draw.cu
ITEMS = 8       # FD_ITEMS


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


def _scan(x: torch.Tensor, ident, op) -> torch.Tensor:
    """Inclusive scan in the kernel's block order (module docstring)."""
    n = x.shape[0]
    chunk = THREADS * ITEMS
    nch = max(1, -(-n // chunk))
    pad = torch.full((nch * chunk - n,), ident, dtype=x.dtype, device=x.device)
    xs = torch.cat([x, pad]).reshape(nch, THREADS, ITEMS)
    loc = [xs[:, :, 0]]
    for e in range(1, ITEMS):
        loc.append(op(loc[-1], xs[:, :, e]))
    loc = torch.stack(loc, dim=2)
    incl = loc[:, :, ITEMS - 1]
    d = 1
    while d < THREADS:
        incl = torch.cat([incl[:, :d], op(incl[:, d:], incl[:, :-d])], dim=1)
        d *= 2
    first = torch.zeros((nch, THREADS, 1), dtype=torch.bool, device=x.device)
    first[:, 0] = True
    excl = torch.cat([torch.full((nch, 1), ident, dtype=x.dtype,
                                 device=x.device), incl[:, :-1]], dim=1)
    pre = torch.where(first, loc, op(excl[:, :, None], loc))
    out = [pre[0]]
    carry = incl[0, THREADS - 1]
    for c in range(1, nch):
        out.append(op(carry, pre[c]))
        carry = op(carry, incl[c, THREADS - 1])
    return torch.stack(out).reshape(-1)[:n]


def _scan_f32(x: torch.Tensor) -> torch.Tensor:
    return _scan(x, 0.0, torch.add)


def _scan_i32(x: torch.Tensor) -> torch.Tensor:
    return _scan(x, 0, torch.add)


def _cummax_i32(x: torch.Tensor) -> torch.Tensor:
    return _scan(x, -(1 << 31), torch.maximum)


def arrivals(key, acap: int, device) -> torch.Tensor:
    """The float32 arrival times: the kernel-ordered running sum of
    ``-log1p(-u)`` over ``acap`` Threefry uniforms of stream 0, then its
    running max. The sum's block order can round an element an ulp below
    its predecessor after a tiny gap (at a thread or chunk boundary); the
    max keeps the arrivals ascending, as the draw needs, and is exact in
    any order."""
    u = threefry.uniforms_plain(key, acap, stream=0, device=device)
    return torch.cummax(_scan_f32(-torch.log1p(-u)), 0).values


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
    U = _scan_i32(uniq.to(I32))
    S = _scan_i32(torch.where(uniq, sign[seg], 0).to(I32))

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
    gc = _cummax_i32(torch.where(uniq, gval, -(1 << 30)).to(I32))

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
    C = _scan_i32((u < p32[r]).to(I32))
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


_METHODS = {"exprace": 0, "ptbern_flat": 1}  # FD_EXPRACE / FD_PTBERN


def _launch(entry: str, arena, key, params, layout, method: str, cap: int,
            acap: int, n: int):
    """Launch ``fused_draw_launch`` (with ``arena``) or
    ``fused_sample_launch`` (``arena`` None) on the params' device.
    Returns ``(rows or None, positions, scalars)``; raises if the kernel
    cannot be built or launched."""
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

    fn = getattr(build.library("fused_draw"), f"{entry}_launch")
    walk = arena is not None
    head = [ctypes.c_void_p, ctypes.c_void_p] if walk else []
    fn.argtypes = (head + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * (12 if walk else 11))
    fn.restype = ctypes.c_int
    R = ops[3].shape[0]
    k0, k1 = threefry.key_words(key)
    rows = None
    args = []
    if walk:
        if arena.device != dev:
            raise ValueError(f"arena on {arena.device}, params on {dev}")
        table = layout_table(layout)
        rows = torch.empty((layout.num_slots, cap), dtype=I32, device=dev)
        args = [arena.contiguous().data_ptr(),
                (ctypes.c_int * len(table))(*table)]
    positions = torch.empty((cap,), dtype=I32, device=dev)
    scalars = torch.empty((2,), dtype=I32, device=dev)
    v = torch.empty((lanes,), dtype=F32, device=dev)
    scratch = torch.empty((5, lanes), dtype=I32, device=dev)
    edges = torch.empty((2, R + 1), dtype=I32, device=dev)
    args += [k0, k1, _METHODS[method], *[t.data_ptr() for t in ops], R,
             lanes, cap]
    if walk:
        args.append(rows.data_ptr())
    args += [positions.data_ptr(), scalars.data_ptr(), v.data_ptr(),
             *[scratch[i].data_ptr() for i in range(5)],
             edges[0].data_ptr(), edges[1].data_ptr()]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        build.check(fn(*args, stream), entry)
    return rows, positions, scalars


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
    return rows, positions, scalars[0], scalars[1].to(torch.bool)


fused_draw.launches = 0


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
    return positions, scalars[0], scalars[1].to(torch.bool)


fused_sample.launches = 0
