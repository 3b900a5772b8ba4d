"""Sharded Poisson sampling: root partitioning and the per-shard indexes.

The join result is the disjoint union of the joins of any partition of
the ROOT relation's rows, and Poisson trials are independent per tuple.
So block-partitioning the root into shards and sampling each block under
its own folded key is distributionally identical to sampling globally:
no coordination, no rejection, and one sum of counts for the global
count. (A fixed-k sampler would need a multivariate-hypergeometric split
of k across shards.)

This module is the library layer the engine's sharded path
(``engine/sharding.py``) consumes:

  * ``semijoin_filter``  — top-down pre-filter bounding the replicated
                           child relations by the root's join keys;
  * ``partition_root``   — block-partition the root with padding (pad rows
                           repeat the last row, with p = 0);
  * ``build_stacked``    — per-shard indexes of identical shapes, pads
                           weight-zeroed, each on its shard's device;
  * ``reshard_incremental`` — advance them to a new snapshot, rebuilding
                           only the shards whose inputs changed;
  * ``fold_shard_key``   — the shard-folded key scheme.

The reference stacks the per-shard indexes into one pytree with a leading
shard axis for ``shard_map``. The port is single-controller (one process
launches each shard's draw on its device), so its stack is a tuple of
per-shard ``Shred``s; the semantics are the reference's: the same shard
count, the same pads, one arena layout (or none) for every shard, the
same per-shard arrays, and join sizes that sum to the global size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy
from repro_torch.kernels import threefry

from .database import Database
from .jointree import JoinQuery, JoinTreeNode
from .relations import Relation, dense_keys
from .shred import Shred, build_plan, build_shred, pack_index

__all__ = [
    "RootPartition", "StackedShred", "ShardedPoissonSampler",
    "partition_root", "semijoin_filter", "build_stacked_shred",
    "build_stacked", "reshard_incremental", "fold_shard_key",
]

I64 = torch.int64


def fold_shard_key(key, coords: Sequence[int], sizes: Sequence[int]):
    """The key of the shard at ``coords`` over mesh axes of ``sizes``:
    ``fold_in(key, s)`` with the coordinates linearized as the reference
    does inside ``shard_map`` (``s = s * size(a) + index(a)``, the first
    axis most significant), so shard ``s`` of the stack draws under
    ``fold_in(key, s)``. Returns (2,) uint32 words."""
    s = 0
    for c, n in zip(coords, sizes):
        s = s * int(n) + int(c)
    return threefry.fold_in(key, s)


def _take(rel: Relation, idx: torch.Tensor) -> Relation:
    return Relation({c: v[idx] for c, v in rel.columns.items()})


def _to(db: Database, device: torch.device) -> Database:
    """``db`` with every column on ``device`` (no copy where it is)."""
    if db.device == device:
        return db
    rels = {name: Relation({c: v.to(device) for c, v in r.columns.items()})
            for name, r in db.relations.items()}
    return Database(rels, db.schemas, device, db.version)


def semijoin_filter(db: Database, query: JoinQuery) -> Database:
    """Top-down semijoin pre-filter: drop child rows that cannot join.

    Walks the (rerooted) join tree from the root, keeping in each child
    relation only the rows whose join key occurs in the parent's (already
    filtered) instance. A relation referenced by several atoms keeps the
    union of the rows any alias needs. The root relation is never
    filtered: it is the partitioned side. Only dangling rows go, which the
    build keeps with weight 0 anyway, so the join and every flat position
    are unchanged; the filter bounds the replicated children."""
    plan = build_plan(query)
    keep: Dict[str, torch.Tensor] = {}

    def visit(tnode: JoinTreeNode, parent_inst: Optional[Relation]) -> None:
        inst = db.instance_for(tnode.atom)
        if parent_inst is not None:
            shared = sorted(set(parent_inst.columns) & set(inst.columns))
            if shared and inst.num_rows and parent_inst.num_rows:
                kp, kc = dense_keys([parent_inst.column(v) for v in shared],
                                    [inst.column(v) for v in shared])
                mask = torch.isin(kc, kp)
            else:  # cross product (or an empty side): nothing to prune
                mask = torch.ones((inst.num_rows,), dtype=torch.bool,
                                  device=db.device)
            name = tnode.atom.relation
            keep[name] = mask if name not in keep else (keep[name] | mask)
            inst = _take(inst, torch.nonzero(mask).reshape(-1))
        for c in tnode.children:
            visit(c, inst)

    visit(plan, None)
    keep.pop(plan.atom.relation, None)  # the root is partitioned, not filtered
    rels = dict(db.relations)
    for name, mask in keep.items():
        rels[name] = _take(db.relations[name], torch.nonzero(mask).reshape(-1))
    return Database(rels, db.schemas, db.device)


@dataclasses.dataclass(frozen=True)
class RootPartition:
    """A block partition of the root relation into equal-sized shard
    databases. ``shards[s]`` holds root rows [s * rows_per_shard, (s + 1) *
    rows_per_shard) (a short tail padded by repeating the last row); the
    children are shared by every shard. ``valid[s]`` counts the unpadded
    rows: the stacked build zeroes the weights of the rest."""

    shards: Tuple[Database, ...]
    root_name: str
    rows_per_shard: int
    valid: Tuple[int, ...]


def partition_root(db: Database, query: JoinQuery,
                   num_shards: int) -> RootPartition:
    """Split the database into ``num_shards`` copies whose root-relation
    rows block-partition the original. Pad rows repeat the last row and
    get probability 0 when the query has a ``prob_var``; the stacked build
    also zeroes their weights, so pads reach neither samples nor joins."""
    root_atom = build_plan(query).atom
    root_rel = db.relations[root_atom.relation]
    n = root_rel.num_rows
    per = -(-n // num_shards)  # 0 rows -> every shard empty
    prob_col = None
    if query.prob_var is not None:
        for c, v in zip(db.schemas[root_atom.relation], root_atom.variables):
            if v == query.prob_var:
                prob_col = c
    shards, valid = [], []
    for s in range(num_shards):
        lo, hi = min(s * per, n), min((s + 1) * per, n)
        idx = np.arange(lo, hi)
        if hi - lo < per:  # pad with the last row: p = 0, then w = 0
            pad = np.full(per - (hi - lo), max(n - 1, 0))
            idx = np.concatenate([idx, pad])
        take = torch.as_tensor(idx, dtype=I64, device=db.device)
        cols = {}
        for c, v in root_rel.columns.items():
            col = v[take]
            if c == prob_col and hi - lo < per:
                col[hi - lo:] = 0
            cols[c] = col
        rels = dict(db.relations)
        rels[root_atom.relation] = Relation(cols)
        shards.append(Database(rels, db.schemas, db.device))
        valid.append(hi - lo)
    return RootPartition(tuple(shards), root_atom.relation, per, tuple(valid))


@dataclasses.dataclass
class StackedShred:
    """The per-shard indexes of a sharded plan, shard ``s`` on its device.

    What the engine's shred cache holds for a sharded plan, keyed by
    (query fingerprint, rep, mesh shape, shard count). Pad rows carry
    weight 0, so ``prefE[s][-1]`` is shard s's true join size and the
    shards' flattens concatenate to the global flatten. ``w``, ``p`` and
    ``prefE`` read the shards' root weights, probabilities (``None``
    without a ``prob_var``) and exclusive prefixes."""

    shreds: Tuple[Shred, ...]
    num_shards: int
    root_name: str
    prob_var: Optional[str]
    valid: Tuple[int, ...]        # unpadded root rows a shard
    join_sizes: Tuple[int, ...]   # |Q_s(db)| a shard

    @property
    def w(self) -> Tuple[torch.Tensor, ...]:
        return tuple(sh.root.weight for sh in self.shreds)

    @property
    def p(self) -> Optional[Tuple[torch.Tensor, ...]]:
        if self.prob_var is None:
            return None
        return tuple(sh.root.data.column(self.prob_var) for sh in self.shreds)

    @property
    def prefE(self) -> Tuple[torch.Tensor, ...]:
        return tuple(sh.root_prefE for sh in self.shreds)

    @property
    def join_size(self) -> int:
        """|Q(db)|: the shards' join sizes sum to the global size."""
        return int(sum(self.join_sizes))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(sh.device for sh in self.shreds)


def _build_one_shard(sdb: Database, query: JoinQuery, rep: str, valid: int,
                     policy: KernelPolicy) -> Shred:
    """One shard's index, pad rows weight-zeroed after the build (and the
    arena re-packed: it embeds the root prefix)."""
    sh = build_shred(sdb, query, rep=rep, policy=policy)
    n = sh.root.num_rows
    if valid < n:
        keep = torch.arange(n, device=sh.device) < valid
        w = torch.where(keep, sh.root.weight, 0)
        root = dataclasses.replace(sh.root, weight=w)
        prefE = torch.cat([torch.zeros((1,), dtype=I64, device=sh.device),
                           torch.cumsum(w, 0)])
        packed, paged = pack_index(root, prefE, policy)
        sh = Shred(root=root, root_prefE=prefE, rep=sh.rep, packed=packed,
                   paged=paged)
    return sh


def _layout(form):
    return None if form is None else form.layout


def _stack_shards(built, part: RootPartition, query: JoinQuery,
                  num_shards: int) -> StackedShred:
    """Bind the per-shard indexes as one stack. An arena is kept only
    where every shard packed (or paged) one of the same layout: int32
    narrowing is decided a shard, and a mixed verdict drops every shard's
    arena, so that every shard takes the same route (the per-node one)."""
    layouts = {(_layout(b.packed), _layout(b.paged)) for b in built}
    if layouts != {(None, None)} and len(layouts) > 1:
        built = [dataclasses.replace(b, packed=None, paged=None)
                 for b in built]
    sizes = [b.root_prefE[-1].to("cpu") for b in built]
    return StackedShred(
        shreds=tuple(built), num_shards=num_shards, root_name=part.root_name,
        prob_var=query.prob_var, valid=part.valid,
        join_sizes=tuple(int(x) for x in sizes))


def build_stacked(db: Database, query: JoinQuery, num_shards: int,
                  rep: str = "usr", prefilter: bool = True,
                  policy: KernelPolicy = DEFAULT_POLICY,
                  devices: Optional[Sequence[torch.device]] = None,
                  ) -> Tuple[StackedShred, Database]:
    """Build ``num_shards`` identical-shape indexes, shard ``s`` on
    ``devices[s]`` (default: the database's device); also returns the
    (semijoin-filtered) base database the shards were cut from, the anchor
    ``reshard_incremental`` diffs against. The children are filtered once
    and shared by every shard, the root is block-partitioned, and pad
    rows are weight-zeroed, so pads reach neither samples nor flattens."""
    base = semijoin_filter(db, query) if prefilter else db
    part = partition_root(base, query, num_shards)
    devices = devices or [db.device] * num_shards
    built = [_build_one_shard(_to(sdb, devices[s]), query, rep,
                              part.valid[s], policy)
             for s, sdb in enumerate(part.shards)]
    return _stack_shards(built, part, query, num_shards), base


def build_stacked_shred(db: Database, query: JoinQuery, num_shards: int,
                        rep: str = "usr", prefilter: bool = True,
                        policy: KernelPolicy = DEFAULT_POLICY,
                        devices: Optional[Sequence[torch.device]] = None,
                        ) -> StackedShred:
    """``build_stacked`` without the base database."""
    return build_stacked(db, query, num_shards, rep=rep, prefilter=prefilter,
                         policy=policy, devices=devices)[0]


def _relations_equal(a: Relation, b: Relation) -> bool:
    """Value equality of two relations (column names, dtypes, data)."""
    if set(a.columns) != set(b.columns):
        return False
    for c, x in a.columns.items():
        y = b.columns[c]
        if x is not y and (x.dtype != y.dtype or x.shape != y.shape
                           or not torch.equal(x, y.to(x.device))):
            return False
    return True


def reshard_incremental(stacked: StackedShred, base: Database,
                        db_new: Database, query: JoinQuery, num_shards: int,
                        rep: str = "usr",
                        policy: KernelPolicy = DEFAULT_POLICY,
                        ) -> Tuple[StackedShred, Database, int, int]:
    """Advance a stacked index to a new snapshot, rebuilding only the
    shards whose inputs changed.

    ``base`` is the filtered base ``build_stacked`` returned for the old
    snapshot. The new snapshot is filtered and partitioned again (linear
    passes; the per-shard sort-based grouping is what reuse saves); a
    shard is reused as it is when every child relation and its slice of
    the root are value-equal. The result equals a fresh ``build_stacked``
    of ``db_new`` either way, each shard on its old device.

    Returns ``(stacked_new, base_new, shards_reused, shards_rebuilt)``.
    """
    base_new = semijoin_filter(db_new, query)
    part_new = partition_root(base_new, query, num_shards)
    root_atom = build_plan(query).atom
    # Only the query's own child relations feed the shard builds: a delta
    # that also touches other relations must not defeat reuse.
    child_rels = {a.relation for a in query.atoms} - {stacked.root_name}
    children_same = num_shards == stacked.num_shards and all(
        _relations_equal(base.relations[name], base_new.relations[name])
        for name in child_rels)
    devices = [stacked.devices[s % stacked.num_shards]
               for s in range(num_shards)]
    built, reused = [], 0
    for s, sdb in enumerate(part_new.shards):
        old = stacked.shreds[s] if s < stacked.num_shards else None
        if (children_same and part_new.valid[s] == stacked.valid[s]
                and _relations_equal(old.root.data,
                                     sdb.instance_for(root_atom))):
            if old.packed is None and old.paged is None:
                # The stack may have dropped the arenas (a mixed verdict in
                # an earlier snapshot): a reused shard carries what a fresh
                # build would, or the kernel routes stay lost.
                packed, paged = pack_index(old.root, old.root_prefE, policy)
                old = dataclasses.replace(old, packed=packed, paged=paged)
            built.append(old)
            reused += 1
        else:
            built.append(_build_one_shard(_to(sdb, devices[s]), query, rep,
                                          part_new.valid[s], policy))
    return (_stack_shards(built, part_new, query, num_shards), base_new,
            reused, num_shards - reused)


class ShardedPoissonSampler:
    """Data-parallel Poisson sampling over a device mesh: a facade over
    the engine's sharded path (one stacked index, per-shard draws under
    folded keys). New code calls ``QueryEngine.sample(..., mesh=...)``,
    whose caches outlive one query.

    ``lower_step`` (the reference's XLA lowering for its dry run) has no
    meaning without XLA and is not ported."""

    def __init__(self, db: Database, query: JoinQuery, mesh,
                 axes: Tuple[str, ...] = ("data",), rep: str = "usr",
                 method: str = "exprace",
                 kernel_policy: Optional[KernelPolicy] = None):
        from repro_torch.engine import QueryEngine

        self.mesh = mesh
        self.axes = axes
        self.rep = "usr" if rep == "both" else rep
        self.method = method
        self.engine = QueryEngine(db, rep=rep, device=db.device,
                                  kernel_policy=kernel_policy)
        self._plan = self.engine.compile_sharded(
            query, mesh, axes=axes, rep=rep, method=method)
        self.num_shards = self._plan.num_shards
        st = self._plan.stacked
        self.root_name = st.root_name
        self.shreds, self.w, self.p = st.shreds, st.w, st.p
        self.prefE = st.prefE
        self.cap = self._plan.cap
        self.acap = self._plan.acap

    def sample_step(self, key):
        """One independent global Poisson sample: the per-shard samples
        (shard-local positions, each on its device) and the global count."""
        return self._plan.sample_step(key)
