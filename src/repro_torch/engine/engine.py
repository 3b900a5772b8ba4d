"""The query engine: plan once, index once, serve full joins and draws.

``QueryEngine`` owns a bound, immutable ``Database`` on one device; a
shred cache — (query fingerprint, rep) -> built index; a plan cache —
(query fingerprint, spec identity) -> ``CompiledPlan``; a
``CapacityPolicy`` and a ``KernelPolicy``. Repeated queries with the same
fingerprint skip GYO and the index build; both caches are LRU-bounded.
Single draws, batches of draws (``sample_batch``), uniform samples and
full joins of one query share one plan-cache entry.

Sharded execution is the same contract over a device mesh
(``launch.mesh``): ``sample(..., mesh=...)`` / ``full_join(..., mesh=...)``
route through a shard planner to stacked per-shard indexes held in the
same shred cache (keyed by fingerprint x rep x mesh shape x shard count),
so the warm sharded path builds nothing either.

The bound database is a versioned snapshot: cache keys carry its version,
and ``apply_delta`` advances the binding while upgrading warm entries in
place through ``reshred_incremental`` (zero rebuilds) and, for stacked
indexes, ``reshard_incremental`` (shards reused where their inputs did not
change); ``rebind`` drops everything.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.config import DEFAULT_POLICY as DEFAULT_KERNEL_POLICY
from repro_torch.config import KernelPolicy, device_name, resolve_device
from repro_torch.core.database import Database
from repro_torch.core.distributed import (StackedShred, build_stacked,
                                          reshard_incremental)
from repro_torch.core.jointree import JoinQuery
from repro_torch.core.poisson import JoinSample
from repro_torch.core.shred import (Shred, build_plan, build_shred,
                                    reshred_incremental)
from repro_torch.core import yannakakis

from .capacity import CapacityPolicy, DEFAULT_POLICY
from .fingerprint import (executor_key, mesh_fingerprint, plan_key,
                          query_fingerprint, sharded_executor_key,
                          sharded_plan_key)
from .plan import CompiledPlan
from .sharding import ShardedPlan, plan_shards
from .spec import DrawSpec, merge_spec

__all__ = ["QueryEngine", "CacheStats"]


@dataclasses.dataclass
class CacheStats:
    """Observable cache behavior (asserted in tests).

    Stacked (sharded) index builds and hits count in the same
    ``shred_builds`` / ``shred_hits``. ``apply_delta`` reports its work
    apart: ``shred_upgrades`` / ``plan_upgrades`` count warm entries
    advanced incrementally (never through ``shred_builds``: upgrading is
    not rebuilding), and ``shards_reused`` / ``shards_rebuilt`` split a
    stacked index's upgrade by shard.

    Stats add across engines: a fleet reports
    ``CacheStats.aggregate(r.engine.stats for r in replicas)``."""

    shred_builds: int = 0
    shred_hits: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    shred_upgrades: int = 0
    plan_upgrades: int = 0
    shards_reused: int = 0
    shards_rebuilt: int = 0

    def snapshot(self) -> "CacheStats":
        return dataclasses.replace(self)

    def __add__(self, other: "CacheStats") -> "CacheStats":
        if not isinstance(other, CacheStats):
            return NotImplemented
        return CacheStats(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(CacheStats)})

    @classmethod
    def aggregate(cls, stats) -> "CacheStats":
        """The field-wise sum over an iterable of per-engine stats (an
        empty iterable gives all-zero stats)."""
        total = cls()
        for s in stats:
            total = total + s
        return total


@dataclasses.dataclass
class _IndexEntry:
    """One shred-cache slot: the index and what ``apply_delta`` needs to
    upgrade it (for a stacked index, the filtered base snapshot it was cut
    from)."""

    index: Union[Shred, StackedShred]
    query: JoinQuery
    version: int
    base: Optional[Database] = None   # stacked entries: filtered base db


class QueryEngine:
    """Plans, caches, and dispatches acyclic-join queries over one database.

    Usage::

        engine = QueryEngine(db)                      # db on the card
        full   = engine.full_join(query)              # Yannakakis via index
        smp    = engine.sample(query, threefry.key(0))  # EXPRACE, same index

    ``device=None`` is the card (raises without one); the database must
    live on the engine's device.
    """

    def __init__(self, db: Database, *, rep: str = "usr",
                 policy: Optional[CapacityPolicy] = None,
                 kernel_policy: Optional[KernelPolicy] = None,
                 max_plans: int = 64, device=None):
        if rep not in ("csr", "usr", "both"):
            raise ValueError(f"rep must be csr|usr|both, got {rep!r}")
        self.device = resolve_device(device)
        if db.device != self.device:
            raise ValueError(f"database on {db.device}, engine on {self.device}")
        self.db = db
        self.rep = rep
        self.policy = policy or DEFAULT_POLICY
        self.kernel_policy = kernel_policy or DEFAULT_KERNEL_POLICY
        self.max_plans = max_plans
        self.stats = CacheStats()
        self._shreds: "collections.OrderedDict[Tuple, _IndexEntry]" = \
            collections.OrderedDict()
        self._plans: "collections.OrderedDict[Tuple, CompiledPlan]" = \
            collections.OrderedDict()
        # Shard-planner verdicts, (ShardPlan, root relation) by (query,
        # mesh shape, axes): apply_delta drops those whose root was
        # touched, rebind drops all.
        self._shard_verdicts: "collections.OrderedDict[Tuple, tuple]" = \
            collections.OrderedDict()

    # -- cache plumbing ------------------------------------------------------
    def _shred_for(self, query: JoinQuery, rep: str) -> Shred:
        key = plan_key(query, rep, self.db.version)
        hit = self._shreds.get(key)
        if hit is not None:
            self._shreds.move_to_end(key)
            self.stats.shred_hits += 1
            return hit.index
        self.stats.shred_builds += 1
        shred = build_shred(self.db, query, rep=rep, policy=self.kernel_policy)
        self._shreds[key] = _IndexEntry(shred, query, self.db.version)
        while len(self._shreds) > self.max_plans:
            self._shreds.popitem(last=False)
        return shred

    def _stacked_shred_for(self, query: JoinQuery, rep: str, mesh,
                           axes: Tuple[str, ...],
                           num_shards: int) -> StackedShred:
        """The stacked per-shard index of a sharded plan, shard ``s`` on
        the mesh's device for it; in the same LRU as single-device shreds
        under a mesh-extended key."""
        key = sharded_plan_key(query, rep, mesh, num_shards, self.db.version)
        hit = self._shreds.get(key)
        if hit is not None:
            self._shreds.move_to_end(key)
            self.stats.shred_hits += 1
            return hit.index
        self.stats.shred_builds += 1
        stacked, base = build_stacked(self.db, query, num_shards, rep=rep,
                                      policy=self.kernel_policy,
                                      devices=mesh.shard_devices(axes))
        self._shreds[key] = _IndexEntry(stacked, query, self.db.version,
                                        base=base)
        while len(self._shreds) > self.max_plans:
            self._shreds.popitem(last=False)
        return stacked

    def compile(self, query: JoinQuery, spec: Optional[DrawSpec] = None, *,
                rep: Optional[str] = None,
                method: Optional[str] = None,
                project: Optional[tuple] = None,
                narrow: Optional[bool] = None,
                kernels: Optional[str] = None) -> CompiledPlan:
        """Plan + index for a query; cached by fingerprint. ``project`` is
        the bag-projection attributes A of beta_y(pi_A(Q^)) (eq. 2)."""
        spec = merge_spec(spec, rep=rep, method=method,
                          project=tuple(project) if project else None,
                          narrow=narrow, kernels=kernels)
        crep = spec.rep or self.rep
        if spec.project is not None and query.prob_var is not None \
                and query.prob_var not in spec.project:
            raise ValueError("prob_var (y) must be in the projection A")
        key = executor_key(query, crep, spec.method, spec.project,
                           self.db.version, spec.narrow, spec.kernels)
        hit = self._plans.get(key)
        if hit is not None:
            self._plans.move_to_end(key)
            self.stats.plan_hits += 1
            return hit
        self.stats.plan_misses += 1
        plan = CompiledPlan(query=query, spec=spec.plan_view(crep),
                            shred=self._shred_for(query, crep),
                            policy=self.policy,
                            kernel_policy=self.kernel_policy)
        self._plans[key] = plan
        while len(self._plans) > self.max_plans:
            self._plans.popitem(last=False)
        return plan

    def compile_sharded(self, query: JoinQuery, mesh,
                        spec: Optional[DrawSpec] = None, *,
                        axes: Optional[tuple] = None,
                        rep: Optional[str] = None,
                        method: Optional[str] = None,
                        project: Optional[tuple] = None,
                        narrow: Optional[bool] = None,
                        kernels: Optional[str] = None,
                        ) -> Union[CompiledPlan, ShardedPlan]:
        """Plan + stacked index for a query over ``mesh``.

        The shard planner picks the partition axes and count from the
        mesh shape, the root relation's size and the ``CapacityPolicy``
        (pass ``axes`` to pin them). A degenerate plan (one shard, no
        axes) falls back to the single-device ``CompiledPlan``: a
        one-entry mesh costs nothing over no mesh."""
        spec = merge_spec(spec, rep=rep, method=method,
                          project=tuple(project) if project else None,
                          narrow=narrow, kernels=kernels,
                          axes=tuple(axes) if axes is not None else None)
        crep = spec.rep or self.rep
        vkey = (query_fingerprint(query), mesh_fingerprint(mesh), spec.axes)
        hit = self._shard_verdicts.get(vkey)
        if hit is None:  # GYO + planner only on the first sighting
            root_atom = build_plan(query).atom
            root_rows = self.db.relations[root_atom.relation].num_rows
            sp = plan_shards(mesh, root_rows, self.policy, axes=spec.axes)
            self._shard_verdicts[vkey] = (sp, root_atom.relation)
            while len(self._shard_verdicts) > self.max_plans:
                self._shard_verdicts.popitem(last=False)
        else:
            sp, _ = hit
        if not sp.axes:
            return self.compile(query, spec)
        key = sharded_executor_key(query, crep, spec.method, spec.project,
                                   mesh, sp.axes, self.db.version,
                                   spec.narrow, spec.kernels)
        hit = self._plans.get(key)
        if hit is not None:
            self._plans.move_to_end(key)
            self.stats.plan_hits += 1
            return hit
        self.stats.plan_misses += 1
        plan = ShardedPlan(
            query=query, spec=spec.plan_view(crep), mesh=mesh, axes=sp.axes,
            stacked=self._stacked_shred_for(query, crep, mesh, sp.axes,
                                            sp.num_shards),
            policy=self.policy, kernel_policy=self.kernel_policy,
            device=self.device)
        self._plans[key] = plan
        while len(self._plans) > self.max_plans:
            self._plans.popitem(last=False)
        return plan

    def rebind(self, db: Database) -> "QueryEngine":
        """Bind a new database, dropping both caches. Always invalidates —
        an identical schema can carry different values, and indexes depend
        on values. For derived snapshots ``apply_delta`` keeps the caches
        warm instead."""
        if db.device != self.device:
            raise ValueError(f"database on {db.device}, engine on {self.device}")
        self.db = db
        self._shreds.clear()
        self._plans.clear()
        self._shard_verdicts.clear()  # root sizes may differ
        return self

    def apply_delta(self, delta) -> "QueryEngine":
        """Advance the bound snapshot to ``self.db.apply(delta)`` and
        upgrade every warm cache entry instead of dropping it.

        Indexes of queries the delta touches are merged forward through
        ``reshred_incremental`` (equal to a rebuild, at the delta's cost)
        under the engine's ``KernelPolicy``; their plans are bound to the
        upgraded index in place. Stacked indexes are partitioned again and
        only the shards whose inputs changed are rebuilt
        (``reshard_incremental``; ``shards_reused`` / ``shards_rebuilt``).
        Entries of queries the delta does not touch are re-keyed to the
        new version for free. A plan whose index fell out of the cache
        upgrades from its own index; a sharded one is dropped (no base
        snapshot to diff against)."""
        old_db = self.db
        new_db = old_db.apply(delta)
        new_v = new_db.version
        touched = set(delta.touched())

        upgraded: Dict[Tuple, object] = {}  # key less version -> new index
        new_shreds: "collections.OrderedDict[Tuple, _IndexEntry]" = \
            collections.OrderedDict()
        for key, entry in self._shreds.items():
            if not touched & {a.relation for a in entry.query.atoms}:
                entry = dataclasses.replace(entry, version=new_v)
            elif isinstance(entry.index, StackedShred):
                stacked, base, reused, rebuilt = reshard_incremental(
                    entry.index, entry.base, new_db, entry.query,
                    entry.index.num_shards, rep=key[1],
                    policy=self.kernel_policy)
                self.stats.shred_upgrades += 1
                self.stats.shards_reused += reused
                self.stats.shards_rebuilt += rebuilt
                entry = _IndexEntry(stacked, entry.query, new_v, base=base)
            else:
                shred = reshred_incremental(entry.index, old_db, entry.query,
                                            delta, self.kernel_policy, new_db)
                self.stats.shred_upgrades += 1
                entry = _IndexEntry(shred, entry.query, new_v)
            upgraded[key[:-1]] = entry.index
            new_shreds[key[:-1] + (new_v,)] = entry
        self._shreds = new_shreds

        new_plans: "collections.OrderedDict[Tuple, CompiledPlan]" = \
            collections.OrderedDict()
        for key, plan in self._plans.items():
            if touched & {a.relation for a in plan.query.atoms}:
                if isinstance(plan, ShardedPlan):
                    stacked = upgraded.get(sharded_plan_key(
                        plan.query, key[1], plan.mesh, plan.num_shards)[:-1])
                    if stacked is None:  # orphan: nothing to diff against
                        continue
                    plan.rebind_stacked(stacked)
                else:
                    shred = upgraded.get(plan_key(plan.query, key[1])[:-1])
                    if shred is None:  # orphan: upgrade from its own index
                        shred = reshred_incremental(plan.shred, old_db,
                                                    plan.query, delta,
                                                    self.kernel_policy,
                                                    new_db)
                        self.stats.shred_upgrades += 1
                    plan.rebind_shred(shred)
                self.stats.plan_upgrades += 1
            new_plans[key[:-1] + (new_v,)] = plan
        self._plans = new_plans
        # Verdicts keyed off a touched root relation are stale (its row
        # count may have moved); the planner runs again on next sight.
        for vkey in [k for k, (_, root) in self._shard_verdicts.items()
                     if root in touched]:
            del self._shard_verdicts[vkey]
        self.db = new_db
        return self

    # -- entry points --------------------------------------------------------
    def _plan_for(self, query: JoinQuery, spec: DrawSpec):
        """The plan a call takes: the sharded plan when the spec carries a
        mesh (or its single-device fallback), else ``compile``."""
        if spec.mesh is not None:
            return self.compile_sharded(query, spec.mesh, spec)
        return self.compile(query, spec)

    def full_join(self, query: JoinQuery, spec: Optional[DrawSpec] = None, *,
                  rep: Optional[str] = None, mesh=None,
                  axes: Optional[tuple] = None) -> Dict[str, torch.Tensor]:
        """Yannakakis full join via the cached index, in the canonical
        flatten order. With a mesh the root is block-partitioned over its
        data axes and each shard flattens its block; the gathered result
        equals the single-device one, order included."""
        spec = merge_spec(spec, rep=rep, mesh=mesh,
                          axes=tuple(axes) if axes is not None else None)
        plan = self._plan_for(query, spec)
        if isinstance(plan, ShardedPlan):
            return plan.full_join()
        return plan.full_join(rep=spec.rep)

    def poisson_sample(self, query: JoinQuery, key,
                       spec: Optional[DrawSpec] = None, *,
                       cap: Optional[int] = None, acap: Optional[int] = None,
                       rep: Optional[str] = None,
                       method: Optional[str] = None,
                       project: Optional[tuple] = None,
                       narrow: Optional[bool] = None,
                       kernels: Optional[str] = None,
                       auto: bool = False, mesh=None,
                       axes: Optional[tuple] = None) -> JoinSample:
        """One independent Poisson sample of ``beta_y(Q)`` via the cached
        index. ``key`` is two uint32 words (``kernels.threefry.key``).
        ``auto=True`` applies the policy's redraw-on-overflow loop.

        With a mesh, shard ``s`` draws under ``fold_in(key, s)`` and the
        shards' samples are gathered (global positions); a degenerate mesh
        falls back to the single-device plan."""
        spec = merge_spec(spec, cap=cap, acap=acap, rep=rep, method=method,
                          project=tuple(project) if project else None,
                          narrow=narrow, kernels=kernels, mesh=mesh,
                          axes=tuple(axes) if axes is not None else None)
        if query.prob_var is None:
            raise ValueError("Poisson sampling needs query.prob_var (beta_y)")
        plan = self._plan_for(query, spec)
        if auto:
            return plan.sample_auto(key, cap=spec.cap, acap=spec.acap)
        if isinstance(plan, ShardedPlan):
            return plan.sample(key, cap=spec.cap, acap=spec.acap)
        return plan.sample(key, cap=spec.cap, acap=spec.acap,
                           rep=spec.rep if spec.rep != "both" else None)

    sample = poisson_sample

    def sample_batch(self, query: JoinQuery, keys,
                     spec: Optional[DrawSpec] = None, *,
                     cap: Optional[int] = None, acap: Optional[int] = None,
                     rep: Optional[str] = None,
                     method: Optional[str] = None,
                     project: Optional[tuple] = None,
                     narrow: Optional[bool] = None,
                     kernels: Optional[str] = None, mesh=None,
                     axes: Optional[tuple] = None) -> JoinSample:
        """``B`` independent Poisson draws of ``beta_y(Q)`` in one
        dispatch. ``keys`` is (B, 2) uint32 words — ``threefry.keys(seed,
        B)`` for the canonical stream (the words of ``jax.random.split``).
        The result's leaves carry a leading batch axis (columns/positions
        ``(B, cap)``, count/overflow ``(B,)``) and lane ``b`` equals
        ``sample(query, keys[b])`` with the same spec and kwargs. The plan
        is the same cache entry the single-draw path uses. With a mesh,
        each shard draws the batch in one dispatch under its folded keys."""
        spec = merge_spec(spec, cap=cap, acap=acap, rep=rep, method=method,
                          project=tuple(project) if project else None,
                          narrow=narrow, kernels=kernels, mesh=mesh,
                          axes=tuple(axes) if axes is not None else None)
        if query.prob_var is None:
            raise ValueError("Poisson sampling needs query.prob_var (beta_y)")
        plan = self._plan_for(query, spec)
        if isinstance(plan, ShardedPlan):
            return plan.sample_batch(keys, cap=spec.cap, acap=spec.acap)
        return plan.sample_batch(keys, cap=spec.cap, acap=spec.acap,
                                 rep=spec.rep if spec.rep != "both" else None)

    def uniform_sample(self, query: JoinQuery, key, p: float, *,
                       spec: Optional[DrawSpec] = None,
                       cap: Optional[int] = None, method: str = "hybrid",
                       rep: Optional[str] = None) -> JoinSample:
        """beta_p with one fixed probability for every join tuple (§6.1).

        ``method`` here selects the *position* sampler (hybrid/bern/geo/
        binom) — it is unrelated to ``DrawSpec.method``, so a ``spec``
        contributes only ``rep``/``cap``/``narrow`` on this path."""
        spec = merge_spec(spec, cap=cap, rep=rep)
        plan = self.compile(query, rep=spec.rep, narrow=spec.narrow)
        return plan.uniform_sample(key, p, cap=spec.cap, method=method)

    def join_size(self, query: JoinQuery) -> int:
        """|Q(db)| in O(1) from the cached index (never materialized)."""
        return self.compile(query).join_size

    def cache_info(self) -> Dict[str, object]:
        """The bound snapshot version plus every cache entry's version."""
        return {
            "db_version": self.db.version,
            "shreds": [{"fingerprint": k[0], "rep": k[1], "version": e.version,
                        "stacked": isinstance(e.index, StackedShred)}
                       for k, e in self._shreds.items()],
            "plans": [{"fingerprint": k[0], "rep": k[1], "version": k[-1],
                       "sharded": isinstance(p, ShardedPlan)}
                      for k, p in self._plans.items()],
        }

    def explain(self, query: JoinQuery, *, rep: Optional[str] = None) -> str:
        """Human-readable plan: the (rerooted) join tree, the routes chosen,
        and the cache state."""
        plan = self.compile(query, rep=rep)
        tree = build_plan(query)
        lines = [
            f"QueryEngine plan  rep={plan.rep}  method={plan.method}  "
            f"device={self.device} ({device_name(self.device)})",
            f"  GET rep={plan.rep_default}  draw route={plan.route}",
            "  join tree (GYO):",
        ]
        lines += ["    " + l for l in tree.pretty().rstrip().split("\n")]
        info = self.cache_info()
        fp = query_fingerprint(query)
        entry_vs = sorted({e["version"] for e in info["shreds"] + info["plans"]
                           if e["fingerprint"] == fp})
        lines += [
            f"  |Q(db)| = {plan.join_size}",
            f"  db version={info['db_version']}  "
            f"entry versions={entry_vs or [info['db_version']]}",
            f"  cached shreds={len(self._shreds)} plans={len(self._plans)} "
            f"(hits: shred={self.stats.shred_hits} plan={self.stats.plan_hits}"
            f"; upgrades: shred={self.stats.shred_upgrades} "
            f"plan={self.stats.plan_upgrades})",
        ]
        return "\n".join(lines)

    # -- baselines (not cached) ----------------------------------------------
    def materialize_and_scan(self, key, query: JoinQuery,
                             uniform_p: Optional[float] = None):
        """The M&S baseline: end-to-end materialize-then-Bernoulli, which
        deliberately bypasses the engine caches — it rebuilds its index per
        call, exactly the naive cost the I&P plans are measured against."""
        return yannakakis.materialize_and_scan(
            key, self.db, query, uniform_p=uniform_p, rep=self.rep,
            policy=self.kernel_policy)
