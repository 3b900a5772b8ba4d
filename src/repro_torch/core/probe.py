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
in one launch of the ``fused_draw`` kernel, routed by ``select_draw``;
``draw_fused_batch`` serves B keys in one launch of the same kernel.

The paged rung, for an int32 index over a budget whose every page fits
it: the GET (rep 'usr_paged') walks the pages with ``tree_probe_paged``;
the draw (``draw_paged``, ``kernels='paged'``) samples positions with
``fused_sample`` and walks them with ``tree_probe_paged``, one launch of
the GET kernel over the pages' buffer on the card; ``draw_paged_batch`` is one batched
``fused_sample`` launch and one GET launch over all B x cap lanes. The
GET's budget is ``KernelPolicy.arena_limit``, the draw's ``draw_limit``.

CSR-GET (rep 'csr'): the paper's linked-list walk, one launch of the
``csr_walk`` kernel an edge: each probe walks its same-key chain from its
head, passing weight-0 rows. ``csr_get_rows_cached`` is the paper's
caching walk (Fig. 11) over ascending probes: along a run of equal heads
a probe resumes where the previous one stopped (``csr_walk_cached``, one
thread a run). Both give the USR GET's rows on the same index.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import tile_for
from repro_torch.kernels.csr_walk import csr_walk, csr_walk_cached
from repro_torch.kernels.fused_draw import (fused_draw, fused_draw_batch,
                                            fused_draw_batch_plain,
                                            fused_draw_plain, fused_sample,
                                            fused_sample_batch)
from repro_torch.kernels.tree_probe import tree_probe, tree_probe_paged

from .sampling import PositionSample
from .shred import PagedArena, Shred, ShredNode

__all__ = ["get", "get_rows", "gather_columns", "csr_get_rows",
           "csr_get_rows_cached", "usr_get_rows",
           "usr_get_rows_fused", "usr_get_rows_paged", "fused_available",
           "paged_view", "paged_available", "select_rep",
           "draw_fused_available", "draw_paged_available", "select_draw",
           "draw_fused", "draw_paged", "draw_fused_batch",
           "draw_paged_batch"]

I64 = torch.int64
I32 = torch.int32


def _int32_index(shred: Shred) -> bool:
    """Did the shred build an int32 index (monolithic or paged)? Either
    form certifies that every prefix value fits int32."""
    return shred.packed is not None or shred.paged is not None


def _root_locate(shred: Shred, pos: torch.Tensor,
                 policy: KernelPolicy = DEFAULT_POLICY
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary search the root prefix vector: pos -> (root row j, local
    offset i). Through the bsearch kernel over the int32 index's root
    prefix (``Shred.root_pref32``, a view) when the shred built an int32
    index, monolithic or paged (every prefix value fits int32), and
    kernels are preferred on this device; the int64 local offset comes
    from the original prefix either way."""
    prefE = shred.root_prefE
    n = shred.root.num_rows
    if _int32_index(shred) and n and policy.preferred(prefE.device):
        j = torch.clamp(
            ops.searchsorted_prefix(shred.root_pref32, pos.to(I32), policy),
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


def paged_view(shred: Shred):
    """The shred's ``PagedArena``, or ``None``: the build-time one when
    ``pack_index`` paged the index, else the paged view of its packed
    arena (a call-time policy with a smaller budget pages it without a
    rebuild)."""
    if shred.paged is not None:
        return shred.paged
    if shred.packed is not None:
        return PagedArena.from_packed(shred.packed)
    return None


def _index_layout(shred: Shred):
    form = shred.packed if shred.packed is not None else shred.paged
    return None if form is None else form.layout


def _pages_fit(shred: Shred, budget: int, policy: KernelPolicy) -> bool:
    """Is there an int32 index whose every page fits ``budget`` and whose
    whole fits the policy's ``paged_limit``?"""
    layout = _index_layout(shred)
    return (layout is not None and layout.max_page <= budget
            and layout.size <= policy.paged_limit)


def paged_available(shred: Shred,
                    policy: KernelPolicy = DEFAULT_POLICY) -> bool:
    """Does this shred take the paged GET? The fused GET does not apply
    (``fused_available`` wins when both would), kernels are enabled, and
    every page fits ``arena_limit``."""
    return (policy.enabled and not fused_available(shred, policy)
            and _pages_fit(shred, policy.arena_limit, policy))


def select_rep(shred: Shred, base: str,
               policy: KernelPolicy = DEFAULT_POLICY) -> Tuple[str, bool]:
    """Given the rep a plan would use, return ``(rep, narrow)``: upgrade
    USR down the kernel ladder (the fused GET, else the paged GET), and
    narrow the sampler's prefix searches to int32, iff the shred built an
    int32 index (monolithic or paged) AND kernels are preferred on its
    device."""
    prefer = policy.preferred(shred.device)
    narrow = _int32_index(shred) and prefer
    if base == "usr" and prefer:
        if fused_available(shred, policy):
            return "usr_fused", narrow
        if paged_available(shred, policy):
            return "usr_paged", narrow
    return base, narrow


def usr_get_rows_fused(shred: Shred, pos: torch.Tensor,
                       policy: KernelPolicy = DEFAULT_POLICY
                       ) -> Dict[str, torch.Tensor]:
    """Resolve probe positions to per-node rows in ONE kernel launch; the
    same rows as ``usr_get_rows``. Without a usable arena, the paged GET
    where its pages fit, else the per-node GET. Positions are narrowed to
    int32 — exact, because an int32 index guarantees join_size < 2^31 and
    callers clamp pads to n - 1."""
    if not fused_available(shred, policy):
        if paged_available(shred, policy):
            return usr_get_rows_paged(shred, pos, policy)
        return usr_get_rows(shred, pos, policy)
    packed = shred.packed
    k = pos.numel()
    out = tree_probe(packed.arena, pos.to(I32), packed.layout,
                     block_rows=tile_for("tree_probe", k, policy, pos.device))
    return {name: out[i] for i, name in enumerate(packed.layout.names)}


def usr_get_rows_paged(shred: Shred, pos: torch.Tensor,
                       policy: KernelPolicy = DEFAULT_POLICY
                       ) -> Dict[str, torch.Tensor]:
    """The paged GET: the walk of ``usr_get_rows_fused`` over the paged
    index (``tree_probe_paged``); the same rows as ``usr_get_rows``. Callers
    reach it through ``select_rep``/``get_rows`` (rep 'usr_paged'), which
    checked ``paged_available``; positions narrow to int32 as in the
    fused GET."""
    pv = paged_view(shred)
    k = pos.numel()
    out = tree_probe_paged(pv, pos.to(I32), block_rows=tile_for(
        "tree_probe_paged", k, policy, pos.device))
    return {name: out[i] for i, name in enumerate(pv.layout.names)}


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


def draw_paged_available(shred: Shred, dparams, *, method: str, n: int = 0,
                         policy: KernelPolicy = DEFAULT_POLICY) -> bool:
    """Can the paged draw run this method on this shred? The fused draw
    cannot (no packed arena within ``draw_limit``), kernels are enabled,
    the plan-bound parameter vectors exist, and every page fits
    ``draw_limit``. The same method gates as the fused draw."""
    if dparams is None or not policy.enabled:
        return False
    packed = shred.packed
    if packed is not None and packed.layout.size <= policy.draw_limit:
        return False
    if not _pages_fit(shred, policy.draw_limit, policy):
        return False
    if method == "ptbern_flat":
        return 0 < n <= policy.draw_limit
    return method == "exprace"


def select_draw(shred: Shred, dparams, *, method: str, n: int = 0,
                kernels: str = "auto",
                policy: KernelPolicy = DEFAULT_POLICY) -> str:
    """Resolve a ``DrawSpec.kernels`` request to the draw route, at plan
    bind time: ``'fused'`` (one launch), ``'paged'`` (a sampling launch,
    then the walk page by page), ``'reference'`` (the same math as plain
    torch ops) or ``'pernode'`` (the float64 route).

      * ``'auto'``      — fused iff capable and the policy enables and
                          prefers kernel draws on the shred's device; else
                          paged under the same gates; else pernode.
      * ``'fused'``     — raise unless capable and enabled.
      * ``'paged'``     — raise unless the paged draw is capable.
      * ``'reference'`` — raise unless either is capable.
      * ``'pernode'``   — always honored.
    """
    capable = draw_fused_available(shred, dparams, method=method, n=n,
                                   policy=policy)
    paged_capable = draw_paged_available(shred, dparams, method=method, n=n,
                                         policy=policy)
    if kernels == "pernode":
        return "pernode"
    if kernels == "paged":
        if not paged_capable:
            raise ValueError(
                "kernels='paged' requested but the paged draw is "
                "unavailable here (needs an int32 index over the draw "
                "budget whose every page fits it, certified int32 "
                "narrowing, an exprace/ptbern_flat method, and kernels "
                "enabled)")
        return "paged"
    if kernels == "fused":
        if not (capable and policy.enabled):
            raise ValueError(
                "kernels='fused' requested but the fused draw is "
                "unavailable here (needs a packed arena within the draw "
                "budget, certified int32 narrowing, an exprace/ptbern_flat "
                "method, and kernels enabled)")
        return "fused"
    if kernels == "reference":
        if not (capable or paged_capable):
            raise ValueError(
                "kernels='reference' requested but the fused-draw operands "
                "are unavailable here (needs an int32 index within the "
                "draw budget, or paged within it, and certified int32 "
                "narrowing)")
        return "reference"
    if kernels != "auto":
        raise ValueError(f"unknown kernels request {kernels!r}")
    if policy.fused_draw and policy.preferred(shred.device):
        if capable:
            return "fused"
        if paged_capable:
            return "paged"
    return "pernode"


def _draw_arena(shred: Shred):
    """The arena the draw walks: the packed one, else the paged index's
    buffer (the whole arena, for the plain version)."""
    if shred.packed is not None:
        return shred.packed.arena, shred.packed.layout
    return shred.paged.buffer, shred.paged.layout


def draw_fused(shred: Shred, dparams, key, *, method: str, cap: int,
               acap: int = 0, n: int = 0, reference: bool = False):
    """Run the one-launch draw: key -> per-node rows + ``PositionSample``.
    ``reference=True`` runs the plain version instead (on any device),
    also on a paged-only index, whose buffer is the whole arena.

    Returns ``(node_rows, ps)``: node name -> (cap,) int32 rows (lanes
    beyond ``ps.count`` arbitrary-but-masked) and a ``PositionSample``
    with the int64 / sentinel-n conventions."""
    arena, layout = _draw_arena(shred)
    run = fused_draw_plain if reference else fused_draw
    rows, pos, cnt, ovf = run(arena, key, dparams, layout=layout,
                              method=method, cap=cap, acap=acap, n=n)
    node_rows = {name: rows[i] for i, name in enumerate(layout.names)}
    return node_rows, PositionSample(pos.to(I64), cnt.to(I64), ovf)


def draw_paged(shred: Shred, dparams, key, *, method: str, cap: int,
               acap: int = 0, n: int = 0,
               policy: KernelPolicy = DEFAULT_POLICY):
    """The paged draw: positions from one ``fused_sample`` launch (the
    same sampling as the fused draw, so the same positions under one
    key), then their walk over the paged index (``tree_probe_paged``). Same
    return contract as ``draw_fused``."""
    pv = paged_view(shred)
    pos, cnt, ovf = fused_sample(key, dparams, method=method, cap=cap,
                                 acap=acap, n=n)
    # Sentinel lanes walk position n - 1 (arbitrary-but-masked, as in GET).
    wpos = torch.clamp(pos, max=dparams["prefE32"][-1] - 1)
    rows = tree_probe_paged(pv, wpos, block_rows=tile_for(
        "tree_probe_paged", cap, policy, wpos.device))
    node_rows = {name: rows[i] for i, name in enumerate(pv.layout.names)}
    return node_rows, PositionSample(pos.to(I64), cnt.to(I64), ovf)


def draw_fused_batch(shred: Shred, dparams, keys, *, method: str, cap: int,
                     acap: int = 0, n: int = 0, reference: bool = False):
    """``draw_fused`` under the (B, 2) ``keys`` in one launch of the draw
    kernel (``reference=True``: its plain version, per key). Returns
    ``(node_rows, ps)`` with a leading batch axis: node name -> (B, cap)
    rows, and positions (B, cap), count and overflow (B,); lane b equals
    ``draw_fused`` under ``keys[b]``."""
    arena, layout = _draw_arena(shred)
    run = fused_draw_batch_plain if reference else fused_draw_batch
    rows, pos, cnt, ovf = run(arena, keys, dparams, layout=layout,
                              method=method, cap=cap, acap=acap, n=n)
    node_rows = {name: rows[:, i] for i, name in enumerate(layout.names)}
    return node_rows, PositionSample(pos.to(I64), cnt.to(I64), ovf)


def draw_paged_batch(shred: Shred, dparams, keys, *, method: str, cap: int,
                     acap: int = 0, n: int = 0,
                     policy: KernelPolicy = DEFAULT_POLICY):
    """``draw_paged`` under the (B, 2) ``keys``: one batched
    ``fused_sample`` launch, then one GET over all B x cap positions (the
    walk is per lane, so each key's rows are its single paged draw's).
    Same return contract as ``draw_fused_batch``."""
    pv = paged_view(shred)
    pos, cnt, ovf = fused_sample_batch(keys, dparams, method=method, cap=cap,
                                       acap=acap, n=n)
    wpos = torch.clamp(pos, max=dparams["prefE32"][-1] - 1)
    rows = tree_probe_paged(pv, wpos.reshape(-1), block_rows=tile_for(
        "tree_probe_paged", wpos.numel(), policy, wpos.device))
    node_rows = {name: rows[i].reshape(pos.shape)
                 for i, name in enumerate(pv.layout.names)}
    return node_rows, PositionSample(pos.to(I64), cnt.to(I64), ovf)


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------

def _csr_sub(node: ShredNode, rows, local, walk, out: Dict[str, torch.Tensor]):
    out[node.name] = rows
    for ci, child in enumerate(node.children):
        w_safe = torch.clamp(node.child_w[ci][rows], min=1)
        idx = torch.remainder(local, w_safe)
        local = torch.div(local, w_safe, rounding_mode="floor")
        hd = node.child_hd[ci][rows]
        crows, clocal = walk(child.weight, child.nxt, hd, idx)
        crows = torch.clamp(crows, min=0)  # clamp sentinel lanes
        _csr_sub(child, crows, clocal, walk, out)


def csr_get_rows(shred: Shred, pos: torch.Tensor,
                 policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    """Resolve probe positions to per-node row indices (CSR): each edge's
    chain walk from the probes' heads (``csr_walk``). The root is located
    as the USR GET locates it (the bsearch kernel over an int32 index)."""
    assert shred.rep in ("csr", "both"), "index was not built with CSR columns"
    rows, local = _root_locate(shred, pos, policy)
    out: Dict[str, torch.Tensor] = {}
    _csr_sub(shred.root, rows, local, csr_walk, out)
    return out


def csr_get_rows_cached(shred: Shred, pos: torch.Tensor,
                        policy: KernelPolicy = DEFAULT_POLICY
                        ) -> Dict[str, torch.Tensor]:
    """``csr_get_rows`` with the paper's caching walk (Fig. 11,
    ``csr_walk_cached``): a probe resumes the walk of the previous probe
    on the same chain. Expects ascending ``pos`` (samplers emit sorted
    positions); the rows are ``csr_get_rows``'s."""
    assert shred.rep in ("csr", "both"), "index was not built with CSR columns"
    rows, local = _root_locate(shred, pos, policy)
    out: Dict[str, torch.Tensor] = {}
    _csr_sub(shred.root, rows, local, csr_walk_cached, out)
    return out


def get_rows(shred: Shred, pos: torch.Tensor, rep: str = None,
             policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    rep = rep or ("usr" if shred.rep in ("usr", "both") else "csr")
    if rep == "usr_fused":
        return usr_get_rows_fused(shred, pos, policy)
    if rep == "usr":
        return usr_get_rows(shred, pos, policy)
    if rep == "usr_paged":
        return usr_get_rows_paged(shred, pos, policy)
    return csr_get_rows(shred, pos, policy)


def gather_columns(shred: Shred, node_rows: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Per-node row indices -> owned output columns (the gather half of
    GET), shared by the positional routes and the fused draw. Rows of any
    shape ((cap,), or (B, cap) for a batch) give columns of that shape."""
    out: Dict[str, torch.Tensor] = {}
    for node in shred.root.nodes():
        rows = node_rows[node.name]
        flat = rows.reshape(-1)
        for v in node.owned:
            out[v] = torch.index_select(node.data.column(v), 0,
                                        flat).reshape(rows.shape)
    return out


def get(shred: Shred, pos: torch.Tensor, rep: str = None,
        policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    """idx.GET(pos): the bag of join tuples at the given flat positions.
    Lanes whose pos is out of range hold arbitrary values and must be
    masked by the caller."""
    return gather_columns(shred, get_rows(shred, pos, rep, policy))
