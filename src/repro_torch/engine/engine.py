"""The query engine: plan once, index once, serve full joins and draws.

``QueryEngine`` owns a bound, immutable ``Database`` on one device; a
shred cache — (query fingerprint, rep) -> built index; a plan cache —
(query fingerprint, spec identity) -> ``CompiledPlan``; a
``CapacityPolicy`` and a ``KernelPolicy``. Repeated queries with the same
fingerprint skip GYO and the index build; both caches are LRU-bounded.
Single draws, batches of draws (``sample_batch``), uniform samples and
full joins of one query share one plan-cache entry.

Not ported yet (ROADMAP queue A): the CSR index, ``apply_delta``/``rebind``
(deltas), meshes and sharded plans.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import DEFAULT_POLICY as DEFAULT_KERNEL_POLICY
from repro_torch.config import KernelPolicy, device_name, resolve_device
from repro_torch.core.database import Database
from repro_torch.core.jointree import JoinQuery
from repro_torch.core.poisson import JoinSample
from repro_torch.core.shred import Shred, build_plan, build_shred
from repro_torch.core import yannakakis

from .capacity import CapacityPolicy, DEFAULT_POLICY
from .fingerprint import executor_key, plan_key, query_fingerprint
from .plan import CompiledPlan
from .spec import DrawSpec, merge_spec

__all__ = ["QueryEngine", "CacheStats"]


@dataclasses.dataclass
class CacheStats:
    """Observable cache behavior (asserted in tests)."""

    shred_builds: int = 0
    shred_hits: int = 0
    plan_hits: int = 0
    plan_misses: int = 0


@dataclasses.dataclass
class _IndexEntry:
    """One shred-cache slot."""

    index: Shred
    query: JoinQuery
    version: int


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
        if rep not in ("usr", "both"):
            raise ValueError(f"rep must be usr|both, got {rep!r}")
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

    # -- entry points --------------------------------------------------------
    def full_join(self, query: JoinQuery, spec: Optional[DrawSpec] = None, *,
                  rep: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Yannakakis full join via the cached index, in the canonical
        flatten order."""
        spec = merge_spec(spec, rep=rep)
        return self.compile(query, spec).full_join(rep=spec.rep)

    def poisson_sample(self, query: JoinQuery, key,
                       spec: Optional[DrawSpec] = None, *,
                       cap: Optional[int] = None, acap: Optional[int] = None,
                       rep: Optional[str] = None,
                       method: Optional[str] = None,
                       project: Optional[tuple] = None,
                       narrow: Optional[bool] = None,
                       kernels: Optional[str] = None,
                       auto: bool = False) -> JoinSample:
        """One independent Poisson sample of ``beta_y(Q)`` via the cached
        index. ``key`` is two uint32 words (``kernels.threefry.key``).
        ``auto=True`` applies the policy's redraw-on-overflow loop."""
        spec = merge_spec(spec, cap=cap, acap=acap, rep=rep, method=method,
                          project=tuple(project) if project else None,
                          narrow=narrow, kernels=kernels)
        if query.prob_var is None:
            raise ValueError("Poisson sampling needs query.prob_var (beta_y)")
        plan = self.compile(query, spec)
        if auto:
            return plan.sample_auto(key, cap=spec.cap, acap=spec.acap)
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
                     kernels: Optional[str] = None) -> JoinSample:
        """``B`` independent Poisson draws of ``beta_y(Q)`` in one
        dispatch. ``keys`` is (B, 2) uint32 words — ``threefry.keys(seed,
        B)`` for the canonical stream (the words of ``jax.random.split``).
        The result's leaves carry a leading batch axis (columns/positions
        ``(B, cap)``, count/overflow ``(B,)``) and lane ``b`` equals
        ``sample(query, keys[b])`` with the same spec and kwargs. The plan
        is the same cache entry the single-draw path uses."""
        spec = merge_spec(spec, cap=cap, acap=acap, rep=rep, method=method,
                          project=tuple(project) if project else None,
                          narrow=narrow, kernels=kernels)
        if query.prob_var is None:
            raise ValueError("Poisson sampling needs query.prob_var (beta_y)")
        plan = self.compile(query, spec)
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
            "shreds": [{"fingerprint": k[0], "rep": k[1], "version": e.version}
                       for k, e in self._shreds.items()],
            "plans": [{"fingerprint": k[0], "rep": k[1], "version": k[-1]}
                      for k in self._plans],
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
            f"(hits: shred={self.stats.shred_hits} plan={self.stats.plan_hits})",
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
