"""Random access into the (virtual) flattened join result (paper §4).

The GET is bulk: the probe vector ``pos`` is processed as one
data-parallel batch.

USR-GET: one binary search per tree node per probe, over the child's
global exclusive weight prefix; a run's weight interval is contiguous in
that prefix, so the search stays inside the joining group.

Fused USR-GET (rep 'usr_fused'): the whole walk in ONE launch of the
``tree_probe`` kernel over the shred's int32 arena. It gives the same rows
as the per-node GET.

The one-launch draw (``draw_fused``): key -> positions and per-node rows
in one launch of the ``fused_draw`` kernel, routed by ``select_draw``.

Not ported yet (ROADMAP queue A): CSR GET, the paged rung (rep
'usr_paged', ``kernels='paged'``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.fused_draw import fused_draw, fused_draw_plain
from repro_torch.kernels.tree_probe import tree_probe

from .sampling import PositionSample
from .shred import Shred, ShredNode

__all__ = ["get", "get_rows", "gather_columns", "usr_get_rows",
           "usr_get_rows_fused", "fused_available", "select_rep",
           "draw_fused_available", "select_draw", "draw_fused"]

I64 = torch.int64
I32 = torch.int32
_PAGED = ("the paged rung is not ported yet (ROADMAP queue A: paged "
          "arena, queue B: fused_sample and tree_probe_paged)")


def _root_locate(shred: Shred, pos: torch.Tensor,
                 policy: KernelPolicy = DEFAULT_POLICY
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary search the root prefix vector: pos -> (root row j, local
    offset i). Through the bsearch kernel on int32-narrowed views when the
    shred packed an arena (every prefix value fits int32) and kernels are
    preferred on this device; the int64 local offset comes from the
    original prefix either way."""
    prefE = shred.root_prefE
    n = shred.root.num_rows
    if shred.packed is not None and n and policy.preferred(prefE.device):
        j = torch.clamp(
            ops.searchsorted_prefix(prefE.to(I32), pos.to(I32), policy),
            max=n - 1).to(I64)
    else:
        j = torch.clamp(torch.searchsorted(prefE, pos, right=True) - 1,
                        0, max(n - 1, 0))
    local = pos - prefE[j]
    return j.to(I32), local.to(I64)


def _usr_child_locate(node: ShredNode, ci: int, rows: torch.Tensor,
                      idx: torch.Tensor):
    """Locate offset ``idx`` within the child-ci group of parent ``rows``:
    one global search over the child's exclusive weight prefix."""
    child = node.children[ci]
    start = node.child_start[ci][rows]
    cumw_excl = child.cumw_excl
    target = cumw_excl[start] + idx
    jj = torch.clamp(torch.searchsorted(cumw_excl, target, right=True) - 1,
                     0, child.num_rows - 1)
    local = target - cumw_excl[jj]
    return child.perm[jj].to(I32), local.to(I64)


def _usr_sub(node: ShredNode, rows, local, out: Dict[str, torch.Tensor]):
    out[node.name] = rows
    # Mixed-radix split (paper eq. 6-7): child 0 is least significant.
    for ci, child in enumerate(node.children):
        w_safe = torch.clamp(node.child_w[ci][rows], min=1)
        idx = torch.remainder(local, w_safe)
        local = torch.div(local, w_safe, rounding_mode="floor")
        crows, clocal = _usr_child_locate(node, ci, rows, idx)
        _usr_sub(child, crows, clocal, out)


def usr_get_rows(shred: Shred, pos: torch.Tensor,
                 policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    """Resolve probe positions to per-node row indices (USR, per node)."""
    assert shred.rep in ("usr", "both"), "index was not built with USR columns"
    rows, local = _root_locate(shred, pos, policy)
    out: Dict[str, torch.Tensor] = {}
    _usr_sub(shred.root, rows, local, out)
    return out


def fused_available(shred: Shred,
                    policy: KernelPolicy = DEFAULT_POLICY) -> bool:
    """Does this shred take the fused GET kernel? (arena packed, within
    the policy's ``arena_limit``, kernels enabled)"""
    return (shred.packed is not None
            and shred.packed.layout.size <= policy.arena_limit
            and policy.enabled)


def select_rep(shred: Shred, base: str,
               policy: KernelPolicy = DEFAULT_POLICY) -> Tuple[str, bool]:
    """Given the rep a plan would use, return ``(rep, narrow)``: upgrade
    USR to the fused GET kernel, and narrow the sampler's prefix searches
    to int32, iff the shred packed an arena AND kernels are preferred on
    its device."""
    prefer = policy.preferred(shred.device)
    narrow = shred.packed is not None and prefer
    if base == "usr" and prefer and fused_available(shred, policy):
        return "usr_fused", narrow
    return base, narrow


def usr_get_rows_fused(shred: Shred, pos: torch.Tensor,
                       policy: KernelPolicy = DEFAULT_POLICY
                       ) -> Dict[str, torch.Tensor]:
    """Resolve probe positions to per-node rows in ONE kernel launch; the
    same rows as ``usr_get_rows``. Without a usable arena, the per-node
    GET. Positions are narrowed to int32 — exact, because a packed arena
    guarantees join_size < 2^31 and callers clamp pads to n - 1."""
    if not fused_available(shred, policy):
        return usr_get_rows(shred, pos, policy)
    packed = shred.packed
    out = tree_probe(packed.arena, pos.to(I32), packed.layout)
    return {name: out[i] for i, name in enumerate(packed.layout.names)}


def draw_fused_available(shred: Shred, dparams, *, method: str, n: int = 0,
                         policy: KernelPolicy = DEFAULT_POLICY) -> bool:
    """Can the one-launch draw (or its plain version) run this method on
    this shred? Needs the arena within the policy's ``draw_limit`` and the
    plan-bound parameter vectors (``None`` when int32 narrowing cannot be
    certified); flat PTBERN's n lanes share the budget. Ignores
    ``policy.enabled``: the reference route runs with kernels disabled."""
    if dparams is None or shred.packed is None:
        return False
    if shred.packed.layout.size > policy.draw_limit:
        return False
    if method == "ptbern_flat":
        return 0 < n <= policy.draw_limit
    return method == "exprace"


def select_draw(shred: Shred, dparams, *, method: str, n: int = 0,
                kernels: str = "auto",
                policy: KernelPolicy = DEFAULT_POLICY) -> str:
    """Resolve a ``DrawSpec.kernels`` request to the draw route, at plan
    bind time: ``'fused'`` (one launch), ``'reference'`` (the same math as
    plain torch ops) or ``'pernode'`` (the float64 route).

      * ``'auto'``      — fused iff capable and the policy enables and
                          prefers it on the shred's device; else pernode.
      * ``'fused'``     — raise unless capable and enabled.
      * ``'reference'`` — raise unless capable.
      * ``'pernode'``   — always honored.
      * ``'paged'``     — not ported: raises ``NotImplementedError``.
    """
    capable = draw_fused_available(shred, dparams, method=method, n=n,
                                   policy=policy)
    if kernels == "pernode":
        return "pernode"
    if kernels == "paged":
        raise NotImplementedError(_PAGED)
    if kernels == "fused":
        if not (capable and policy.enabled):
            raise ValueError(
                "kernels='fused' requested but the fused draw is "
                "unavailable here (needs a packed arena within the draw "
                "budget, certified int32 narrowing, an exprace/ptbern_flat "
                "method, and kernels enabled)")
        return "fused"
    if kernels == "reference":
        if not capable:
            raise ValueError(
                "kernels='reference' requested but the fused-draw operands "
                "are unavailable here (needs a packed arena within the draw "
                "budget and certified int32 narrowing)")
        return "reference"
    if kernels != "auto":
        raise ValueError(f"unknown kernels request {kernels!r}")
    if (capable and policy.fused_draw
            and policy.preferred(shred.device)):
        return "fused"
    return "pernode"


def draw_fused(shred: Shred, dparams, key, *, method: str, cap: int,
               acap: int = 0, n: int = 0, reference: bool = False):
    """Run the one-launch draw: key -> per-node rows + ``PositionSample``.
    ``reference=True`` runs the plain version instead (on any device).

    Returns ``(node_rows, ps)``: node name -> (cap,) int32 rows (lanes
    beyond ``ps.count`` arbitrary-but-masked) and a ``PositionSample``
    with the int64 / sentinel-n conventions."""
    packed = shred.packed
    run = fused_draw_plain if reference else fused_draw
    rows, pos, cnt, ovf = run(packed.arena, key, dparams,
                              layout=packed.layout, method=method, cap=cap,
                              acap=acap, n=n)
    node_rows = {name: rows[i] for i, name in enumerate(packed.layout.names)}
    return node_rows, PositionSample(pos.to(I64), cnt.to(I64), ovf)


def get_rows(shred: Shred, pos: torch.Tensor, rep: str = None,
             policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    rep = rep or "usr"
    if rep == "usr_fused":
        return usr_get_rows_fused(shred, pos, policy)
    if rep == "usr":
        return usr_get_rows(shred, pos, policy)
    if rep == "usr_paged":
        raise NotImplementedError(_PAGED)
    raise NotImplementedError(
        f"rep={rep!r} is not ported yet (ROADMAP queue A: CSR GET)")


def gather_columns(shred: Shred, node_rows: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Per-node row indices -> owned output columns (the gather half of
    GET), shared by the positional routes and the fused draw."""
    out: Dict[str, torch.Tensor] = {}
    for node in shred.root.nodes():
        rows = node_rows[node.name]
        for v in node.owned:
            out[v] = torch.index_select(node.data.column(v), 0, rows)
    return out


def get(shred: Shred, pos: torch.Tensor, rep: str = None,
        policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    """idx.GET(pos): the bag of join tuples at the given flat positions.
    Lanes whose pos is out of range hold arbitrary values and must be
    masked by the caller."""
    return gather_columns(shred, get_rows(shred, pos, rep, policy))
