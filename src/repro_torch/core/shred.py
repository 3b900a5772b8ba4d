"""Shredded random-access index construction (paper §4), on torch tensors.

Builds the chained (CSR) and/or unchained (USR) shredded representation
of the 2NSA expression ``mu*(E)`` derived from a join tree, in
O(|db| log |db|): one stable argsort per tree edge replaces the paper's
hash grouping.

Zero-weight retention: dangling tuples are kept with weight 0 instead of
being compacted away. A zero-weight tuple produces no flat tuples, so the
flatten order and the prefix vectors are unaffected; a root tuple's weight
is exactly the number of join tuples extending it.

Canonical flatten order: root tuples in physical order; within a nested
attribute, tuples in join-key-sorted (stable) order; combinations in the
paper's mixed-radix order (eq. 6-7, first child least significant). CSR
and USR share this order, so their GETs agree tuple for tuple.

The arena: every probe table (``root_prefE``, then per tree edge in
pre-order ``child_start``, ``child_w``, the child's ``cumw_excl`` and
``perm``) narrowed to int32 and packed into one flat device buffer, which
the GET and draw kernels read through L2. It is packed iff every value
fits int32 and the arena is within ``KernelPolicy.arena_limit``; over it,
it is paged (``PagedArena``: one page for the root prefix, one per tree
edge) iff every page fits ``arena_limit`` and the whole ``paged_limit``.

The arena is packed the same way for every rep (CSR indexes carry
``perm`` and ``cumw_excl`` too).

Incremental maintenance: the build is three reusable passes (edge keys ->
sorted group -> link columns), and ``reshred_incremental`` merges a
``DeltaBatch`` into an existing shred — sorting only the delta and
re-deriving the affected link columns, on the shred's device — with the
contract that the result equals ``build_shred(db.apply(delta), query,
rep, policy)`` array for array, dtypes, arena and pages included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy

from .database import Database
from .delta import keep_tensor
from .jointree import JoinQuery, JoinTreeNode, gyo_join_tree, reroot_for
from .relations import Relation, dense_keys

__all__ = ["ShredNode", "Shred", "build_shred", "build_plan", "PackedShred",
           "PagedArena", "ArenaLayout", "ArenaEdge", "pack_arena",
           "pack_index", "reshred_incremental", "shred_from_arrays"]

I64 = torch.int64
I32 = torch.int32
_I32_MAX = (1 << 31) - 1


@dataclasses.dataclass
class ShredNode:
    """One Sigma(Y) of the shredded representation (a join-tree node).

    Arrays describing this node's rows:
      data      Relation over this node's variables (n rows).
      weight    (n,) int64 — flatten weight of the nested tuple at each row.
    Arrays describing this node's role as a *child* (absent on the root):
      nxt       (n,) int32 CSR same-key chain in sorted order (-1
                terminates; reps 'csr' and 'both').
      perm      (n,) int32 sorted-order -> row id.
      cumw_excl (n+1,) int64 exclusive prefix of weights in sorted order.
    Per-child link columns (aligned with ``children``):
      child_hd    (n,) int32 head row id in child (CSR), -1 if empty.
      child_start (n,) int64 start offset into child's sorted order (USR).
      child_len   (n,) int32 run length in child's sorted order.
      child_w     (n,) int64 total weight of the joining child group.
    """

    name: str
    variables: Tuple[str, ...]
    owned: Tuple[str, ...]  # variables this node materializes in GET output
    data: Relation
    weight: torch.Tensor
    children: Tuple["ShredNode", ...] = ()
    nxt: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None
    cumw_excl: Optional[torch.Tensor] = None
    child_hd: Tuple[torch.Tensor, ...] = ()
    child_start: Tuple[torch.Tensor, ...] = ()
    child_len: Tuple[torch.Tensor, ...] = ()
    child_w: Tuple[torch.Tensor, ...] = ()

    @property
    def num_rows(self) -> int:
        return self.weight.shape[0]

    def nodes(self) -> List["ShredNode"]:
        out = [self]
        for c in self.children:
            out.extend(c.nodes())
        return out


@dataclasses.dataclass(frozen=True)
class ArenaEdge:
    """Arena addressing of one tree edge (element offsets into the arena)."""

    parent: int    # output slot of the parent node
    slot: int      # output slot of the child node (pre-order)
    cs_off: int    # parent's child_start column for this edge (n_parent,)
    cw_off: int    # parent's child_w column for this edge (n_parent,)
    ce_off: int    # child's cumw_excl (n_child + 1,)
    perm_off: int  # child's perm (n_child,)
    n_child: int


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Hashable layout of a packed arena: slot names (pre-order, slot 0 =
    root), root prefix length, and per-edge offsets. The GET and draw
    kernels take it as a small table argument, so one build of each kernel
    serves every layout."""

    names: Tuple[str, ...]
    n_root: int
    root_len: int  # n_root + 1 (root_prefE lives at offset 0)
    edges: Tuple[ArenaEdge, ...]
    size: int      # total arena length in int32 elements

    @property
    def num_slots(self) -> int:
        return len(self.names)

    def page_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """Per-page ``(start, end)`` element ranges of the paged split:
        page 0 is the root prefix, page ``i + 1`` is edge ``i``'s four
        columns (laid out consecutively), so the pages are contiguous
        slices that concatenate back to the whole arena."""
        return ((0, self.root_len),) + tuple(
            (e.cs_off, e.perm_off + e.n_child) for e in self.edges)

    @property
    def max_page(self) -> int:
        """The largest page in int32 elements (what the paged rung gates
        against its page budget)."""
        return max(end - start for start, end in self.page_bounds())


@dataclasses.dataclass
class PackedShred:
    """The int32 index arena plus its layout (and, once asked for, its
    paged view: ``PagedArena.from_packed``)."""

    arena: torch.Tensor  # (size,) int32
    layout: ArenaLayout
    _paged: Optional["PagedArena"] = dataclasses.field(default=None,
                                                       repr=False)


@dataclasses.dataclass
class PagedArena:
    """The same int32 index as ``PackedShred``, addressed page by page.

    ``buffer`` is the whole arena in one contiguous tensor and ``pages``
    are views of it (``layout.page_bounds()``): paging copies nothing, and
    the plain draw reads the buffer itself. ``stacked()`` is the
    one-launch walk's operand, built on first use and kept."""

    buffer: torch.Tensor  # (size,) int32
    layout: ArenaLayout
    _stacked: Optional[Tuple[torch.Tensor, int]] = dataclasses.field(
        default=None, repr=False)

    @property
    def pages(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.buffer[s:e] for s, e in self.layout.page_bounds())

    @classmethod
    def from_packed(cls, packed: PackedShred) -> "PagedArena":
        """The paged view of a monolithic arena (a call-time policy with a
        smaller budget pages an already-packed index without a rebuild),
        made once per arena and kept with it."""
        if packed._paged is None:
            packed._paged = cls(packed.arena, packed.layout)
        return packed._paged

    def stacked(self) -> Tuple[torch.Tensor, int]:
        """``(pages, P)``: the pages stacked into one ``(npages, P)``
        int32 tensor, each zero-padded to ``P``, the largest page rounded
        up to 128 elements."""
        if self._stacked is None:
            P = -(-self.layout.max_page // 128) * 128
            bounds = self.layout.page_bounds()
            out = torch.zeros((len(bounds), P), dtype=I32,
                              device=self.buffer.device)
            for i, (s, e) in enumerate(bounds):
                out[i, :e - s] = self.buffer[s:e]
            self._stacked = (out, P)
        return self._stacked


def _arena_pieces(root: ShredNode, root_prefE: torch.Tensor):
    """The arena's pieces (tensors, in packing order) and its layout, or
    ``None`` when int32 narrowing is refused: an empty node, or any value
    above int32 range."""
    if any(nd.num_rows == 0 for nd in root.nodes()):
        return None
    pieces = [root_prefE]
    names = [root.name]
    edges: List[ArenaEdge] = []
    off = root_prefE.shape[0]

    def walk(node: ShredNode, parent_slot: int) -> None:
        nonlocal off
        for ci, child in enumerate(node.children):
            slot = len(names)
            names.append(child.name)
            cols = (node.child_start[ci], node.child_w[ci], child.cumw_excl,
                    child.perm)
            offs = []
            for c in cols:
                offs.append(off)
                off += c.shape[0]
            pieces.extend(cols)
            edges.append(ArenaEdge(parent_slot, slot, offs[0], offs[1],
                                   offs[2], offs[3], child.num_rows))
            walk(child, slot)

    walk(root, 0)
    tops = [p.max().to(I64) for p in pieces if p.numel()]
    if tops and int(torch.stack(tops).max()) > _I32_MAX:  # one host read
        return None  # narrowing rule: values must fit int32
    layout = ArenaLayout(tuple(names), root.num_rows, root_prefE.shape[0],
                         tuple(edges), off)
    return pieces, layout


def pack_arena(root: ShredNode, root_prefE: torch.Tensor,
               policy: KernelPolicy = DEFAULT_POLICY) -> Optional[PackedShred]:
    """The monolithic arena alone, or ``None`` where the one-launch draw
    could not take it: narrowing refused, or the arena over
    ``policy.draw_limit``. The reference's monolith-only entry point;
    index builds go through ``pack_index``, which pages too."""
    got = _arena_pieces(root, root_prefE)
    if got is None:
        return None
    pieces, layout = got
    if layout.size > policy.draw_limit:
        return None
    return PackedShred(torch.cat([p.to(I32) for p in pieces]), layout)


def pack_index(root: ShredNode, root_prefE: torch.Tensor,
               policy: KernelPolicy = DEFAULT_POLICY
               ) -> Tuple[Optional[PackedShred], Optional[PagedArena]]:
    """Pack the shred's probe tables into int32 device memory. Returns
    ``(packed, paged)``, at most one of them not ``None``:

      * the arena fits ``arena_limit``            -> ``PackedShred``;
      * over it, but every page fits ``arena_limit`` and the whole fits
        ``paged_limit``                           -> ``PagedArena``;
      * narrowing refused, or too large to page   -> ``(None, None)``:
        the per-node int64 path stands.
    """
    got = _arena_pieces(root, root_prefE)
    if got is None:
        return None, None
    pieces, layout = got
    whole = layout.size <= policy.arena_limit
    if not whole and (layout.size > policy.paged_limit
                      or layout.max_page > policy.arena_limit):
        return None, None
    arena = torch.cat([p.to(I32) for p in pieces])
    if whole:
        return PackedShred(arena, layout), None
    return None, PagedArena(arena, layout)


@dataclasses.dataclass
class Shred:
    """The full shredded random-access index: root node + root prefix.

    root_prefE: (n_root + 1,) int64 exclusive prefix of root weights;
    root_prefE[-1] == |Q(db)|. ``packed`` is the int32 arena and
    ``paged`` its paged form; ``pack_index`` sets at most one of them.
    """

    root: ShredNode
    root_prefE: torch.Tensor
    rep: str  # 'csr' | 'usr' | 'both'
    packed: Optional[PackedShred] = None
    paged: Optional[PagedArena] = None

    @property
    def join_size(self) -> torch.Tensor:
        """|Q(db)| — the full join cardinality, O(1) from the index."""
        return self.root_prefE[-1]

    @property
    def device(self) -> torch.device:
        return self.root_prefE.device

    @property
    def root_pref32(self) -> Optional[torch.Tensor]:
        """``root_prefE`` in int32 as a view of the int32 index: the
        arena's first ``root_len`` words (page 0 of a paged index), or
        ``None`` when the shred built no int32 index."""
        form = self.packed if self.packed is not None else self.paged
        if form is None:
            return None
        buf = form.arena if self.packed is not None else form.buffer
        return buf[:form.layout.root_len]


def build_plan(query: JoinQuery) -> JoinTreeNode:
    """Join tree for the query, rerooted so prob_var is flat at the root
    (Proposition 3.1)."""
    tree = gyo_join_tree(query)
    if query.prob_var is not None:
        tree = reroot_for(tree, query.prob_var)
    return tree


def _edge_join_vars(parent_vars: Sequence[str],
                    child_vars: Sequence[str]) -> List[str]:
    """The join attributes of one tree edge, in canonical (sorted) order."""
    return sorted(set(parent_vars) & set(child_vars))


def _edge_keys(parent_rel: Relation, parent_vars: Tuple[str, ...],
               child: ShredNode) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 — one dense int64 join key per parent / child row. A keyless
    edge (a cross product) maps every row to the single key 0."""
    join_vars = _edge_join_vars(parent_vars, child.variables)
    if join_vars:
        return dense_keys(
            [parent_rel.column(v) for v in join_vars],
            [child.data.column(v) for v in join_vars],
        )
    dev = child.weight.device
    return (torch.zeros((parent_rel.num_rows,), dtype=I64, device=dev),
            torch.zeros((child.num_rows,), dtype=I64, device=dev))


def _sorted_group(kc: torch.Tensor, weight: torch.Tensor):
    """Pass 2 — stable-sort the child by join key and prefix-sum its
    weights. ``order`` is sorted position -> row id; ties keep physical
    row order (the canonical flatten order depends on it)."""
    order = torch.argsort(kc, stable=True).to(I32)
    kc_sorted = kc[order]
    w_sorted = weight[order]
    zero = torch.zeros((1,), dtype=I64, device=kc.device)
    cumw_excl = torch.cat([zero, torch.cumsum(w_sorted, 0)])
    return order, kc_sorted, cumw_excl


def _link_columns(kp: torch.Tensor, kc_sorted: torch.Tensor,
                  order: torch.Tensor, cumw_excl: torch.Tensor, rep: str):
    """Pass 3 — each parent row's run boundaries in the sorted child (USR)
    and the chained successor lists (CSR, reps 'csr' and 'both')."""
    n = order.shape[0]
    dev = kp.device
    s = torch.searchsorted(kc_sorted, kp, side="left")
    e = torch.searchsorted(kc_sorted, kp, side="right")
    child_len = (e - s).to(I32)
    child_w = cumw_excl[e] - cumw_excl[s]
    child_start = s.to(I64)
    if n == 0:
        child_hd = torch.full((kp.shape[0],), -1, dtype=I32, device=dev)
    else:
        head = order[torch.clamp(s, max=n - 1)]
        child_hd = torch.where(e > s, head, torch.full_like(head, -1)).to(I32)

    nxt = None
    if rep in ("csr", "both"):
        # nxt[row] = successor row in the same-key sorted run, else -1.
        false1 = torch.zeros((1,), dtype=torch.bool, device=dev)
        same_next = torch.cat([kc_sorted[1:] == kc_sorted[:-1], false1])[:n]
        succ = torch.cat([order[1:], torch.full((1,), -1, dtype=I32,
                                                device=dev)])[:n]
        nxt_sorted = torch.where(same_next, succ,
                                 torch.full_like(succ, -1)).to(I32)
        nxt = torch.zeros((n,), dtype=I32, device=dev)
        nxt[order.to(I64)] = nxt_sorted
    return child_hd, child_start, child_len, child_w, nxt


def _group_child(parent_rel: Relation, parent_vars: Tuple[str, ...],
                 child: ShredNode, rep: str):
    """Group the child by the shared join key; compute the parent's link
    columns (the sort-based analogue of the paper's USR grouping)."""
    kp, kc = _edge_keys(parent_rel, parent_vars, child)
    order, kc_sorted, cumw_excl = _sorted_group(kc, child.weight)
    child_hd, child_start, child_len, child_w, nxt = _link_columns(
        kp, kc_sorted, order, cumw_excl, rep)
    return child_hd, child_start, child_len, child_w, nxt, order, cumw_excl


def _build_node(tnode: JoinTreeNode, db: Database, rep: str,
                owned_above: frozenset) -> ShredNode:
    rel = db.instance_for(tnode.atom)
    rel.validate()
    variables = tuple(tnode.atom.variables)
    owned = tuple(v for v in dict.fromkeys(variables) if v not in owned_above)
    below = owned_above | set(variables)

    children = [_build_node(c, db, rep, below) for c in tnode.children]

    n = rel.num_rows
    weight = torch.ones((n,), dtype=I64, device=db.device)
    hds, starts, lens, ws = [], [], [], []
    new_children = []
    for child in children:
        hd, st, ln, w, nxt, perm, cume = _group_child(rel, variables, child, rep)
        hds.append(hd)
        starts.append(st)
        lens.append(ln)
        ws.append(w)
        new_children.append(
            dataclasses.replace(child, nxt=nxt, perm=perm, cumw_excl=cume))
        weight = weight * w  # zero-weight propagation == semijoin reduction

    return ShredNode(
        name=tnode.atom.name,
        variables=variables,
        owned=owned,
        data=rel.project(tuple(dict.fromkeys(variables))),
        weight=weight,
        children=tuple(new_children),
        child_hd=tuple(hds),
        child_start=tuple(starts),
        child_len=tuple(lens),
        child_w=tuple(ws),
    )


def build_shred(db: Database, query: JoinQuery, rep: str = "usr",
                policy: KernelPolicy = DEFAULT_POLICY) -> Shred:
    """Construct the random-access index (Proposition 4.4 / 4.5) on the
    database's device.

    rep='csr'  — chained representation (successor lists; the paper's).
    rep='usr'  — unchained representation (perm + prefix).
    rep='both' — both sets of link columns (one grouping pass).
    """
    if rep not in ("csr", "usr", "both"):
        raise ValueError(f"rep must be csr|usr|both, got {rep!r}")
    plan = build_plan(query)
    root = _build_node(plan, db, rep, frozenset())
    zero = torch.zeros((1,), dtype=I64, device=db.device)
    prefE = torch.cat([zero, torch.cumsum(root.weight, 0)])
    packed, paged = pack_index(root, prefE, policy)
    return Shred(root=root, root_prefE=prefE, rep=rep, packed=packed,
                 paged=paged)


# ---------------------------------------------------------------------------
# Incremental maintenance
# ---------------------------------------------------------------------------
#
# ``reshred_incremental`` replays a ``DeltaBatch`` through the three build
# passes without re-sorting the unchanged rows: the delta is sorted on its
# own and merged into the existing sorted grouping; link columns and prefix
# vectors are re-derived by count arithmetic and binary searches only on
# the edges whose endpoints changed. Every step is a torch operation on the
# shred's device (stable sorts, ``searchsorted``, int64 ``cumsum``,
# scatters); the host reads scalars only (key ranges, counts, maxima).

_PACK_LIMIT = 1 << 62  # packed multi-column keys must stay well inside int64


def _lexsort(cols: List[torch.Tensor]) -> torch.Tensor:
    """``np.lexsort(cols)``: the LAST column is the primary key. Stable
    argsorts chained from the first column to the last, so the last sort
    decides first."""
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in cols:
        order = order[torch.argsort(c[order], stable=True)]
    return order


def _lex_scalar_keys(sorted_cols: List[torch.Tensor],
                     query_cols: List[torch.Tensor]):
    """Collapse multi-column keys on both sides into order-isomorphic int64
    scalars, in ``dense_keys``' total order (the LAST column primary).
    ``None`` when the value ranges cannot be packed into an int64."""
    if len(sorted_cols) == 1:
        return sorted_cols[0], query_cols[0]
    ends = [torch.stack([c.min(), c.max()])
            for sc, qc in zip(sorted_cols, query_cols)
            for c in (sc, qc) if c.numel()]
    got = torch.stack(ends).tolist() if ends else []  # one host read
    mins, widths = [], []
    for sc, qc in zip(sorted_cols, query_cols):
        mine = [got.pop(0) for c in (sc, qc) if c.numel()]
        lo = min(lh[0] for lh in mine) if mine else 0
        hi = max(lh[1] for lh in mine) if mine else 0
        mins.append(lo)
        widths.append(hi - lo + 1)
    total = 1
    for w in widths:
        total *= w
        if total >= _PACK_LIMIT:
            return None

    def pack(cols):
        acc = cols[-1] - mins[-1]
        for c, lo, w in zip(cols[-2::-1], mins[-2::-1], widths[-2::-1]):
            acc = acc * w + (c - lo)
        return acc

    return pack(sorted_cols), pack(query_cols)


def _lex_searchsorted(sorted_cols: List[torch.Tensor],
                      query_cols: List[torch.Tensor],
                      right: bool) -> torch.Tensor:
    """``searchsorted`` of multi-column keys into a lexicographically
    sorted multi-column sequence (``dense_keys``' total order); over the
    dense ids of the union when the ranges overflow packing."""
    packed = _lex_scalar_keys(sorted_cols, query_cols)
    if packed is None:
        packed = dense_keys(sorted_cols, query_cols)
    return torch.searchsorted(packed[0].contiguous(), packed[1].contiguous(),
                              right=right)


def _edge_key_cols(data: Relation, join_vars: List[str], n: int,
                   device) -> List[torch.Tensor]:
    """Row-order int64 key columns of one edge endpoint; a keyless edge
    (cross product) gets the single all-zero pseudo column."""
    if join_vars:
        return [data.column(v).to(I64) for v in join_vars]
    return [torch.zeros((n,), dtype=I64, device=device)]


@dataclasses.dataclass
class _MergedOrder:
    """One edge's merged sorted grouping, plus the pieces the parent-side
    boundary adjustment reuses."""

    perm: torch.Tensor                # (n_new,) int32 sorted pos -> row id
    keys_sorted: List[torch.Tensor]   # merged int64 key cols, sorted order
    keep_sorted: torch.Tensor         # (n_old,) bool over the OLD order
    ins_keys: List[torch.Tensor]      # insert key cols, sorted among selves


def _merge_sorted_order(old_child: ShredNode, new_child: ShredNode,
                        join_vars: List[str], keep: Optional[torch.Tensor],
                        num_inserts: int) -> _MergedOrder:
    """Merge a child-relation delta into the child's sorted grouping.

    Survivors keep their relative (sorted) order; inserts are sorted among
    themselves and merged in, ties resolved survivors first, then insert
    order — exactly the stable argsort of the post-delta rows. The insert
    keys are the tail of the new child's columns (in the columns' dtypes,
    as the new snapshot holds them)."""
    dev = old_child.weight.device
    perm_old = old_child.perm.to(I64)
    n_old = old_child.num_rows
    if keep is None:
        keep = torch.ones((n_old,), dtype=torch.bool, device=dev)
    new_id = torch.cumsum(keep, 0) - 1               # old row -> new row id
    keep_sorted = keep[perm_old]
    surv_rows_old = perm_old[keep_sorted]            # sorted order, filtered
    surv_ids = new_id[surv_rows_old]
    n_surv = surv_rows_old.shape[0]
    d = num_inserts

    surv_keys = [k[surv_rows_old] for k in _edge_key_cols(
        old_child.data, join_vars, n_old, dev)]
    ins_raw = [k[n_surv:] for k in _edge_key_cols(
        new_child.data, join_vars, n_surv + d, dev)]
    ins_order = _lexsort(ins_raw)                    # stable, last col primary
    ins_keys = [k[ins_order] for k in ins_raw]

    # Insertion points: ties place inserts after equal survivors (right),
    # as the stable argsort does (survivor ids < insert ids).
    ins_pos = _lex_searchsorted(surv_keys, ins_keys, right=True)
    surv = torch.arange(n_surv, device=dev)
    fpos_surv = surv + torch.searchsorted(ins_pos, surv, right=True)
    fpos_ins = ins_pos + torch.arange(d, device=dev)

    perm_new = torch.empty((n_surv + d,), dtype=I32, device=dev)
    perm_new[fpos_surv] = surv_ids.to(I32)
    perm_new[fpos_ins] = (n_surv + ins_order).to(I32)
    keys_new = []
    for sk, ik in zip(surv_keys, ins_keys):
        col = torch.empty((n_surv + d,), dtype=I64, device=dev)
        col[fpos_surv] = sk
        col[fpos_ins] = ik
        keys_new.append(col)
    return _MergedOrder(perm_new, keys_new, keep_sorted, ins_keys)


def _chain_nxt(keys_sorted: List[torch.Tensor],
               perm: torch.Tensor) -> torch.Tensor:
    """The CSR chain over merged sorted keys (``_link_columns``' ``nxt``)."""
    n = perm.shape[0]
    dev = perm.device
    same_next = torch.ones((n,), dtype=torch.bool, device=dev)
    if n:
        same_next[-1] = False
        for k in keys_sorted:
            same_next[:-1] &= k[1:] == k[:-1]
    succ = torch.cat([perm[1:], torch.full((1,), -1, dtype=I32,
                                           device=dev)])[:n]
    nxt_sorted = torch.where(same_next, succ, torch.full_like(succ, -1))
    nxt = torch.zeros((n,), dtype=I32, device=dev)
    nxt[perm.to(I64)] = nxt_sorted.to(I32)
    return nxt


def _reshred_node(tnode: JoinTreeNode, snode: ShredNode, new_db: Database,
                  delta, rep: str, keeps: Dict[str, torch.Tensor]):
    """Post-order walk mirroring ``_build_node``. Returns
    ``(new_node, rows_changed, weight_changed)``; untouched subtrees are
    returned by reference (``new_node is snode``)."""
    atom = tnode.atom
    rd = delta.relations.get(atom.relation)
    rows_changed = rd is not None

    results = [_reshred_node(tc, sc, new_db, delta, rep, keeps)
               for tc, sc in zip(tnode.children, snode.children)]
    if not rows_changed and all(nc is sc for (nc, _, _), sc
                                in zip(results, snode.children)):
        return snode, False, False

    dev = snode.weight.device
    keep_p = keeps.get(atom.relation)
    if rows_changed:  # the new snapshot's columns, as a build takes them
        data_new = new_db.instance_for(atom).project(snode.data.columns)
    else:
        data_new = snode.data
    m_new = data_new.num_rows

    zero = torch.zeros((1,), dtype=I64, device=dev)
    weight = torch.ones((m_new,), dtype=I64, device=dev)
    hds, starts, lens, ws, new_children = [], [], [], [], []
    weight_changed = rows_changed
    for i, ((cnode, c_rows, c_weight), c_old) in enumerate(
            zip(results, snode.children)):
        if not rows_changed and not c_rows and not c_weight:
            # Edge untouched: every link column carries over.
            hds.append(snode.child_hd[i])
            starts.append(snode.child_start[i])
            lens.append(snode.child_len[i])
            ws.append(snode.child_w[i])
            new_children.append(cnode)
            weight = weight * snode.child_w[i]
            continue
        weight_changed = True
        join_vars = _edge_join_vars(snode.variables, cnode.variables)
        c_rel = tnode.children[i].atom.relation
        merged = None
        if c_rows:
            merged = _merge_sorted_order(c_old, cnode, join_vars,
                                         keeps.get(c_rel),
                                         delta.relations[c_rel].num_inserts)
            perm = merged.perm
        else:
            perm = c_old.perm
        if c_rows or c_weight:
            cumw_excl = torch.cat([zero, torch.cumsum(cnode.weight[perm], 0)])
        else:
            cumw_excl = c_old.cumw_excl

        # -- run boundaries (s, e) per parent row ---------------------------
        # Surviving parent rows adjust their stored boundaries (less the
        # child keys the delta deleted before them, plus the ones it
        # inserted: count arithmetic, exact against a search), and only
        # parent-inserted rows search the child's sorted keys.
        s_old = snode.child_start[i]
        e_old = s_old + snode.child_len[i]
        if not rows_changed and not c_rows:
            # Only subtree weights moved: the sorted order and every run
            # boundary stand; refresh the weight-dependent columns.
            s, e = s_old, e_old
            hd, ln = snode.child_hd[i], snode.child_len[i]
        else:
            kp_cols = _edge_key_cols(data_new, join_vars, m_new, dev)
            d_p = rd.num_inserts if rows_changed else 0
            s_surv, e_surv = s_old, e_old
            if rows_changed and keep_p is not None:
                s_surv, e_surv = s_old[keep_p], e_old[keep_p]
            m_surv = m_new - d_p
            kp_surv = [k[:m_surv] for k in kp_cols]  # survivors lead
            kp_ins = [k[m_surv:] for k in kp_cols]
            keys_sorted = merged.keys_sorted if merged is not None else None
            if c_rows:
                cum_del = torch.cat([zero, torch.cumsum(~merged.keep_sorted,
                                                        0)])
                s_surv = (s_surv - cum_del[s_surv] + _lex_searchsorted(
                    merged.ins_keys, kp_surv, right=False))
                e_surv = (e_surv - cum_del[e_surv] + _lex_searchsorted(
                    merged.ins_keys, kp_surv, right=True))
            if d_p:
                if keys_sorted is None:
                    keys_sorted = [k[perm] for k in _edge_key_cols(
                        cnode.data, join_vars, cnode.num_rows, dev)]
                s = torch.cat([s_surv, _lex_searchsorted(keys_sorted, kp_ins,
                                                         right=False)])
                e = torch.cat([e_surv, _lex_searchsorted(keys_sorted, kp_ins,
                                                         right=True)])
            else:
                s, e = s_surv, e_surv
            n_child = perm.shape[0]
            if n_child == 0:
                hd = torch.full((m_new,), -1, dtype=I32, device=dev)
            else:
                head = perm[torch.clamp(s, max=n_child - 1)]
                hd = torch.where(e > s, head,
                                 torch.full_like(head, -1)).to(I32)
            ln = (e - s).to(I32)
        w = cumw_excl[e] - cumw_excl[s]
        start = snode.child_start[i] if s is s_old else s.to(I64)

        if rep in ("csr", "both") and c_rows:
            nxt = _chain_nxt(merged.keys_sorted, perm)
        else:
            nxt = c_old.nxt
        new_children.append(dataclasses.replace(
            cnode, nxt=nxt, perm=perm, cumw_excl=cumw_excl))
        hds.append(hd)
        starts.append(start)
        lens.append(ln)
        ws.append(w)
        weight = weight * w

    new_node = dataclasses.replace(
        snode,
        data=data_new,
        weight=weight if weight_changed else snode.weight,
        children=tuple(new_children),
        child_hd=tuple(hds),
        child_start=tuple(starts),
        child_len=tuple(lens),
        child_w=tuple(ws),
    )
    return new_node, rows_changed, weight_changed


def reshred_incremental(base: Shred, db: Database, query: JoinQuery, delta,
                        policy: KernelPolicy = DEFAULT_POLICY,
                        new_db: Optional[Database] = None) -> Shred:
    """Merge ``delta`` (a ``core.delta.DeltaBatch``) into an existing index.

    ``base`` must be ``build_shred(db, query, rep=base.rep, policy=policy)``
    for the given (pre-delta) snapshot ``db``; the result equals
    ``build_shred(db.apply(delta), query, rep=base.rep, policy=policy)`` —
    the same arrays, dtypes and canonical flatten order, the int32 arena or
    pages included — at the delta's cost: only the delta is sorted, and
    only edges with a touched endpoint (or a changed subtree weight)
    re-derive their link columns and prefix vectors, on ``base``'s device.

    Untouched relations' nodes are shared with ``base`` by reference; a
    delta that touches no relation of the query returns ``base`` itself.
    ``policy`` decides packed against paged, as it did for ``base``.
    The new index shares the columns of ``db.apply(delta)``, as a build of
    it does; ``new_db`` is that snapshot when the caller holds it already.
    """
    used = {a.relation for a in query.atoms}
    if not used & set(delta.relations):
        return base
    if new_db is None:
        new_db = db.apply(delta)
    delta = delta.checked({n: r.num_rows for n, r in db.relations.items()})
    keeps = {name: keep_tensor(d, db.relations[name].num_rows, base.device)
             for name, d in delta.relations.items()
             if name in used and d.delete_mask is not None}
    plan = build_plan(query)
    root, rows_changed, weight_changed = _reshred_node(
        plan, base.root, new_db, delta, base.rep, keeps)
    if root is base.root:
        return base
    if rows_changed or weight_changed:
        zero = torch.zeros((1,), dtype=I64, device=base.device)
        prefE = torch.cat([zero, torch.cumsum(root.weight, 0)])
    else:
        prefE = base.root_prefE
    # The arena is re-packed from the merged arrays (a concatenation), so
    # it equals a fresh build's, the packed-or-paged verdict included.
    packed, paged = pack_index(root, prefE, policy)
    return Shred(root=root, root_prefE=prefE, rep=base.rep, packed=packed,
                 paged=paged)


# ---------------------------------------------------------------------------
# Index from plain arrays (so the port's GET and draw can run on exactly
# the index another build produced).
# ---------------------------------------------------------------------------

def _node_from_arrays(nd: dict, device) -> ShredNode:
    def t(a):
        # A copy: the arrays may be read-only views of another framework's.
        return None if a is None else torch.from_numpy(np.array(a)).to(device)

    return ShredNode(
        name=nd["name"],
        variables=tuple(nd["variables"]),
        owned=tuple(nd["owned"]),
        data=Relation({c: t(v) for c, v in nd["data"].items()}),
        weight=t(nd["weight"]),
        children=tuple(_node_from_arrays(c, device) for c in nd["children"]),
        nxt=t(nd.get("nxt")),
        perm=t(nd.get("perm")),
        cumw_excl=t(nd.get("cumw_excl")),
        child_hd=tuple(t(a) for a in nd["child_hd"]),
        child_start=tuple(t(a) for a in nd["child_start"]),
        child_len=tuple(t(a) for a in nd["child_len"]),
        child_w=tuple(t(a) for a in nd["child_w"]),
    )


def shred_from_arrays(tree: dict, device=None) -> Shred:
    """Build a ``Shred`` from a nested dict of numpy arrays.

    ``tree`` holds ``rep``, ``root_prefE``, ``root`` (a node dict),
    ``arena`` (the packed arena) or ``pages`` (a paged arena's pages, in
    order), and ``layout``; a missing or ``None`` entry means that form
    was not built. A node dict
    holds ``name``, ``variables``, ``owned``, ``data`` (column -> array),
    ``weight``, ``perm``, ``cumw_excl``, ``nxt`` (``None`` on the root),
    the per-child lists ``child_start``, ``child_w``, ``child_len``,
    ``child_hd`` and ``children``. ``layout`` is a dict with ``names``,
    ``n_root``, ``root_len``, ``size`` and ``edges`` (7-tuples in
    ``ArenaEdge`` field order).
    """
    from repro_torch.config import resolve_device

    dev = resolve_device(device)
    packed = paged = None
    if tree.get("layout") is not None:
        lay = tree["layout"]
        layout = ArenaLayout(tuple(lay["names"]), int(lay["n_root"]),
                             int(lay["root_len"]),
                             tuple(ArenaEdge(*map(int, e))
                                   for e in lay["edges"]),
                             int(lay["size"]))
        if tree.get("arena") is not None:
            arena = torch.from_numpy(np.array(tree["arena"], np.int32))
            packed = PackedShred(arena.to(dev), layout)
        elif tree.get("pages") is not None:
            flat = np.concatenate([np.asarray(p, np.int32)
                                   for p in tree["pages"]])
            paged = PagedArena(torch.from_numpy(flat).to(dev), layout)
    return Shred(root=_node_from_arrays(tree["root"], dev),
                 root_prefE=torch.from_numpy(
                     np.array(tree["root_prefE"])).to(dev),
                 rep=tree["rep"], packed=packed, paged=paged)
