"""Shredded random-access index construction (paper §4), on torch tensors.

Builds the unchained (USR) shredded representation of the 2NSA expression
``mu*(E)`` derived from a join tree, in O(|db| log |db|): one stable
argsort per tree edge replaces the paper's hash grouping.

Zero-weight retention: dangling tuples are kept with weight 0 instead of
being compacted away. A zero-weight tuple produces no flat tuples, so the
flatten order and the prefix vectors are unaffected; a root tuple's weight
is exactly the number of join tuples extending it.

Canonical flatten order: root tuples in physical order; within a nested
attribute, tuples in join-key-sorted (stable) order; combinations in the
paper's mixed-radix order (eq. 6-7, first child least significant).

The arena: every probe table (``root_prefE``, then per tree edge in
pre-order ``child_start``, ``child_w``, the child's ``cumw_excl`` and
``perm``) narrowed to int32 and packed into one flat device buffer, which
the GET and draw kernels read through L2. It is packed iff every value
fits int32 and the arena is within ``KernelPolicy.arena_limit``; over it,
it is paged (``PagedArena``: one page for the root prefix, one per tree
edge) iff every page fits ``arena_limit`` and the whole ``paged_limit``.

Not ported yet (ROADMAP queue A): the CSR link columns' GET and
incremental reshredding.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy

from .database import Database
from .jointree import JoinQuery, JoinTreeNode, gyo_join_tree, reroot_for
from .relations import Relation, dense_keys

__all__ = ["ShredNode", "Shred", "build_shred", "build_plan", "PackedShred",
           "PagedArena", "ArenaLayout", "ArenaEdge", "pack_index",
           "shred_from_arrays"]

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
      nxt       (n,) int32 CSR same-key chain in sorted order (rep 'both').
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
    for p in pieces:
        if p.numel() and int(p.max()) > _I32_MAX:
            return None  # narrowing rule: values must fit int32
    layout = ArenaLayout(tuple(names), root.num_rows, root_prefE.shape[0],
                         tuple(edges), off)
    return pieces, layout


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
    rep: str  # 'usr' | 'both'
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
    and the chained successor lists (CSR, rep 'both')."""
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
    if rep == "both":
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

    rep='usr'  — unchained representation (perm + prefix).
    rep='both' — USR plus the CSR successor chains.
    """
    if rep == "csr":
        raise NotImplementedError(
            "rep='csr' is not ported yet (ROADMAP queue A: CSR GET)")
    if rep not in ("usr", "both"):
        raise ValueError(f"rep must be usr|both, got {rep!r}")
    plan = build_plan(query)
    root = _build_node(plan, db, rep, frozenset())
    zero = torch.zeros((1,), dtype=I64, device=db.device)
    prefE = torch.cat([zero, torch.cumsum(root.weight, 0)])
    packed, paged = pack_index(root, prefE, policy)
    return Shred(root=root, root_prefE=prefE, rep=rep, packed=packed,
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
