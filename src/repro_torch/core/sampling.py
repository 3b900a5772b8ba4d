"""Non-uniform (Poisson) position sampling over root groups: EXPRACE, the
per-node float64 route, and the operand tables of the fused draw.

EXPRACE samples a Bernoulli(p) trial per unit cell as "a Poisson process
with rate lambda = -ln(1-p) drops >= 1 arrival in the cell". Over all root
segments this is one inhomogeneous Poisson process with total mass
Lam = sum_t w_t * lambda_t: draw M ~ Poisson(Lam) arrival locations by
inverse CDF, dedupe cells with one sort, and for p > 1/2 sample the
complement (failures) and invert by the l-th-missing-value formula.

The reference draws through ``jax.random``; torch cannot give those bits,
so the per-node route draws through two explicit ``torch.Generator``
streams seeded from the key words (one for M, one for the uniforms,
mirroring the reference's key split). It is checked by distribution.
The sort, ``index_add_``, masked scatter and ``searchsorted`` here are
library calls, as they are XLA operations in the reference; the int32
prefix searches go through the bsearch kernel when the caller hands over
the index's int32 root prefix (``pref32``).

The uniform samplers (BERN/GEO/BINOM/HYBRID) and the host oracles are
not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy
from repro_torch.kernels import ops, threefry

__all__ = ["PositionSample", "exprace_positions", "pt_bern_flat_positions",
           "fused_draw_params", "generators"]

I64 = torch.int64
I32 = torch.int32
F64 = torch.float64
_TINY = 1e-12


@dataclasses.dataclass
class PositionSample:
    """A fixed-capacity probe sequence. positions[i] for i >= count equals
    the sentinel (the join size n) and must be masked downstream."""

    positions: torch.Tensor  # (cap,) int64, ascending over valid lanes
    count: torch.Tensor      # () int64 — number of valid positions
    overflow: torch.Tensor   # () bool — true sample size exceeded cap


def _finish(positions, valid, n, more_beyond) -> PositionSample:
    positions = torch.where(valid, positions, n)
    count = torch.sum(valid).to(I64)
    return PositionSample(positions.to(I64), count, more_beyond)


def generators(key, device):
    """Two device generators from the key words: the streams of M and of
    the arrival uniforms (the reference splits its key in two)."""
    out = []
    for stream in (0, 1):
        s0, s1 = threefry.fold(key, stream)
        g = torch.Generator(device=device)
        g.manual_seed(((s0 << 32) | s1) & ((1 << 63) - 1))
        out.append(g)
    return out


def _locate_prefix(prefE, q, hi: int, narrow: bool,
                   policy: KernelPolicy = DEFAULT_POLICY):
    """clamp(searchsorted(prefE, q, right) - 1, 0, hi), through the
    bsearch kernel on int32 operands when ``narrow`` (the caller
    guarantees every value fits int32 — the shred built an int32 index);
    an int32 ``prefE`` is taken as it is."""
    if narrow:
        prefE, q = prefE.to(I32), q.to(I32)
    return torch.clamp(ops.searchsorted_prefix(prefE, q, policy),
                       max=hi).to(I64)


def exprace_positions(key, w, p, prefE, cap: int, arrival_cap: int = 0,
                      pref32: Optional[torch.Tensor] = None,
                      policy: KernelPolicy = DEFAULT_POLICY) -> PositionSample:
    """EXPRACE positions in float64 (module docstring).

    w:     (R,) int64   flatten weight of each root tuple (0 = dangling)
    p:     (R,) float   sampling probability of each root tuple
    prefE: (R+1,) int64 exclusive prefix of w; prefE[-1] = join size n
    cap:        output position capacity
    arrival_cap: scratch capacity for raw Poisson arrivals (default: cap)
    pref32: prefE in int32 (``Shred.root_pref32``, a view of the int32
            index), given when every integer prefix value fits int32: the
            prefix searches then take the int32 kernel
    """
    narrow = pref32 is not None
    acap = arrival_cap or cap
    dev = w.device
    R = w.shape[0]
    n = prefE[-1]
    gM, gV = generators(key, dev)
    p = torch.clamp(p.to(F64), 0.0, 1.0)
    comp = p > 0.5                       # sample failures instead of successes
    pi = torch.where(comp, 1.0 - p, p)   # process probability, <= 1/2
    lam = -torch.log1p(-torch.clamp(pi, max=0.5))  # rate per cell, <= ln 2
    wF = w.to(F64)

    # --- Poisson arrivals over the piecewise-constant-rate line ------------
    zero = torch.zeros((1,), dtype=F64, device=dev)
    massE = torch.cat([zero, torch.cumsum(wF * lam, 0)])
    Lam = massE[-1]
    M = torch.poisson(Lam.reshape(1), generator=gM).to(I64)[0]
    aM = torch.clamp(M, max=acap)
    v = torch.rand((acap,), dtype=F64, device=dev, generator=gV) * Lam
    avalid = torch.arange(acap, dtype=I64, device=dev) < aM
    r = _locate_prefix(massE, v, R - 1, False, policy)
    cell = torch.floor((v - massE[r]) / torch.clamp(lam[r], min=_TINY)).to(I64)
    cell = torch.minimum(torch.clamp(cell, min=0),
                         torch.clamp(w[r] - 1, min=0))
    gid = torch.where(avalid, prefE[r] + cell, n)  # global cell id; pads -> n

    # --- dedupe cells (>=1 arrival == one success/failure) -----------------
    gid = torch.sort(gid).values
    head = torch.ones((1,), dtype=torch.bool, device=dev)
    uniq = (gid < n) & torch.cat([head, gid[1:] != gid[:-1]])
    seg = _locate_prefix(pref32 if narrow else prefE, gid, R - 1, narrow,
                         policy)
    hits = torch.zeros((R,), dtype=I64, device=dev).index_add_(
        0, seg, uniq.to(I64))
    k_r = torch.where(comp, w - hits, hits)  # success count per root
    izero = torch.zeros((1,), dtype=I64, device=dev)
    outE = torch.cat([izero, torch.cumsum(k_r, 0)])
    K = outE[-1]

    # --- compact the unique cells, in (segment, cell) order ----------------
    urank = torch.cumsum(uniq.to(I64), 0) - 1
    hitsE = torch.cat([izero, torch.cumsum(hits, 0)])
    local = gid - prefE[seg]
    big = torch.iinfo(I64).max
    offE = torch.cat([izero, torch.cumsum(w + 1, 0)])
    lrank = urank - hitsE[seg]
    g_val = local - lrank + offE[seg]
    # Unique lanes scatter to their rank; duplicates to a dropped slot.
    tgt = torch.where(uniq, urank, acap)
    Fc = torch.full((acap + 1,), big, dtype=I64, device=dev)
    Gc = torch.full((acap + 1,), big, dtype=I64, device=dev)
    Fc = Fc.scatter_(0, tgt, torch.where(uniq, local, big))[:acap]
    Gc = Gc.scatter_(0, tgt, torch.where(uniq, g_val, big))[:acap]

    # --- emit output slots --------------------------------------------------
    t = torch.arange(cap, dtype=I64, device=dev)
    tvalid = t < torch.clamp(K, max=cap)
    rO = _locate_prefix(outE, t, R - 1, narrow, policy)
    l = t - outE[rO]
    wm1 = torch.clamp(w[rO] - 1, min=0)
    direct_pos = Fc[torch.clamp(hitsE[rO] + l, 0, acap - 1)]
    q = l + offE[rO]
    c = torch.searchsorted(Gc, q, right=True) - hitsE[rO]
    comp_pos = l + torch.minimum(torch.clamp(c, min=0), wm1 - l + 1)
    local_out = torch.where(comp[rO], comp_pos, direct_pos)
    positions = prefE[rO] + torch.minimum(torch.clamp(local_out, min=0), wm1)
    overflow = (M > acap) | (K > cap)
    return _finish(positions, tvalid, n, overflow)


def pt_bern_flat_positions(key, root_p, prefE, n: int,
                           cap: int) -> PositionSample:
    """Faithful PTBERN, flattened: one Bernoulli trial per flat position
    with that position's root probability. Theta(n) — only for a join
    small enough to enumerate. Successes are compacted by rank into the
    ``cap`` lanes (a scatter with a dropped slot, no host sync)."""
    dev = root_p.device
    R = root_p.shape[0]
    flat = torch.arange(n, dtype=I64, device=dev)
    r = torch.clamp(torch.searchsorted(prefE, flat, right=True) - 1, 0, R - 1)
    u = torch.rand((n,), dtype=F64, device=dev,
                   generator=generators(key, dev)[1])
    mask = u < root_p.to(F64)[r]
    total = torch.sum(mask).to(I64)
    rank = torch.cumsum(mask.to(I64), 0) - 1
    tgt = torch.where(mask & (rank < cap), rank, cap)
    idx = torch.full((cap + 1,), n, dtype=I64, device=dev)
    idx = idx.scatter_(0, tgt, torch.where(mask, flat, n))[:cap]
    valid = torch.arange(cap, dtype=I64, device=dev) < torch.clamp(total, max=cap)
    return _finish(idx, valid, torch.tensor(n, dtype=I64, device=dev),
                   total > cap)


def fused_draw_params(w, p, prefE) -> Optional[dict]:
    """Plan-bound operand vectors of the fused draw: the EXPRACE thinning
    tables (mass prefix, per-cell rates, complement signs) accumulated in
    float64 and cast to float32, plus the int32-narrowed root prefixes.
    ``None`` when the int32 narrowing cannot be certified (join + R beyond
    int32, or an empty join)."""
    R = int(w.shape[0])
    n = int(prefE[-1])
    # offE[-1] = n + R must fit the int32 complement offsets.
    if n <= 0 or n + R >= (1 << 31) - 1:
        return None
    dev = w.device
    p64 = torch.clamp(p.to(F64), 0.0, 1.0)
    comp = p64 > 0.5
    pi = torch.where(comp, 1.0 - p64, p64)
    lam = -torch.log1p(-torch.clamp(pi, max=0.5))
    zero1 = torch.zeros((1,), dtype=F64, device=dev)
    massE = torch.cat([zero1, torch.cumsum(w.to(F64) * lam, 0)])
    izero1 = torch.zeros((1,), dtype=I64, device=dev)
    cwE = torch.cat([izero1, torch.cumsum(torch.where(comp, w, 0), 0)])
    offE = torch.cat([izero1, torch.cumsum(w + 1, 0)])
    return {
        "massE": massE.to(torch.float32),
        "lam": lam.to(torch.float32),
        "sign": torch.where(comp, -1, 1).to(I32),
        "w32": w.to(I32),
        "prefE32": prefE.to(I32),
        "cwE": cwE.to(I32),
        "offE": offE.to(I32),
        "p32": p64.to(torch.float32),
    }
