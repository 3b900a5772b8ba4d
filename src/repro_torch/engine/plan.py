"""Compiled query plans: shred index + executor + capacity metadata.

A ``CompiledPlan`` is the engine's unit of caching: the GYO join tree has
been run, the shred index built, the GET rep and the draw route chosen,
and the fused draw's operand vectors bound. Everything data-dependent (the
key, per-call capacity overrides) stays a call argument, so one plan
serves any number of independent draws, batches of draws, uniform
samples and full-join flattens without rebuilding anything. A delta
upgrades the plan in place (``rebind_shred``): the route, GET rep and
draw tables are bound again for the new index; the capacities only grow.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import DEFAULT_POLICY as DEFAULT_KERNEL_POLICY
from repro_torch.config import KernelPolicy
from repro_torch.core import estimate, probe, sampling
from repro_torch.core.jointree import JoinQuery
from repro_torch.core.poisson import JoinSample
from repro_torch.core.shred import Shred
from repro_torch.core.yannakakis import flatten

from . import executors
from .capacity import CapacityPolicy, DEFAULT_POLICY
from .spec import DrawSpec

__all__ = ["CompiledPlan", "redraw_with_doubling"]


def redraw_with_doubling(draw, cap: int, acap: int, max_doublings: int):
    """Call ``draw(cap, acap)`` until the sample reports no overflow,
    doubling both capacities between attempts. Overflow is always flagged,
    never silent."""
    for _ in range(max_doublings):
        s = draw(cap, acap)
        if not bool(s.overflow):
            return s
        cap *= 2
        acap *= 2
    raise RuntimeError("sample capacity still overflowing after doublings")


@dataclasses.dataclass
class CompiledPlan:
    """One (query fingerprint, spec identity) entry of the plan cache.

    ``spec`` is the resolved plan-identity ``DrawSpec`` (concrete ``rep``).
    w / p / prefE are the root-level weight, probability and exclusive
    prefix vectors (p is None for queries without ``prob_var`` — such
    plans serve full joins and uniform samples only).
    """

    query: JoinQuery
    spec: DrawSpec
    shred: Shred
    policy: CapacityPolicy = DEFAULT_POLICY
    kernel_policy: KernelPolicy = DEFAULT_KERNEL_POLICY

    @property
    def rep(self) -> str:
        return self.spec.rep

    @property
    def method(self) -> str:
        return self.spec.method

    @property
    def project(self) -> Optional[Tuple[str, ...]]:
        return self.spec.project

    def __post_init__(self):
        self._default_cap = None
        self._arrival_cap = None
        self._bind_shred(self.shred)
        self._run = executors.sample_executor(self.method, self.project)
        self._run_batch = executors.batched_sample_executor(self.method,
                                                            self.project)

    def _resolve_narrow(self, shred: Shred, auto_narrow: bool) -> bool:
        """Apply the spec's narrowing override to the auto verdict. Forcing
        ``narrow=True`` needs an int32 index, packed or paged."""
        if self.spec.narrow is None:
            return auto_narrow
        if self.spec.narrow and shred.packed is None and shred.paged is None:
            raise ValueError(
                "DrawSpec(narrow=True) requires an int32 index, packed or "
                "paged (join < 2^31, no empty node); this shred has none")
        return self.spec.narrow

    def _bind_shred(self, shred: Shred) -> None:
        """Bind an index: route, GET rep, narrowing and draw tables are
        chosen again on every bind (a delta can move an arena across
        ``draw_limit`` or cost it its int32 form)."""
        root = shred.root
        self.shred = shred
        self.w = root.weight
        self.prefE = shred.root_prefE
        # One host read per bind; every draw's capacity path uses it.
        self._join_size = int(shred.join_size)
        self.rep_default, auto_narrow = probe.select_rep(
            shred, "usr" if self.rep == "both" else self.rep,
            self.kernel_policy)
        self._narrow = self._resolve_narrow(shred, auto_narrow)
        if self.query.prob_var is not None:
            if self.query.prob_var not in root.variables:
                raise AssertionError("build_plan must reroot prob_var to the root")
            self.p = root.data.column(self.query.prob_var)
            # Sticky capacities: recomputed from the new (w, p) but never
            # below what the plan already used, so a delta that lowers
            # E[k] keeps the buffers' shapes.
            self._default_cap = max(self._default_cap or 0,
                                    self.policy.sample_capacity(self.w, self.p))
            self._arrival_cap = max(self._arrival_cap or 0,
                                    self.policy.arrival_capacity(self.w, self.p))
            dparams = sampling.fused_draw_params(self.w, self.p, self.prefE,
                                                 self.kernel_policy)
            self._route = probe.select_draw(
                shred, dparams, method=self.method, n=self._lanes(),
                kernels=self.spec.kernels, policy=self.kernel_policy)
            self._dparams = dparams if self._route != "pernode" else None
        else:
            self.p = None
            self._route = "pernode"
            self._dparams = None

    def rebind_shred(self, shred: Shred) -> "CompiledPlan":
        """Swap in an (incrementally upgraded) index for a newer snapshot,
        keeping the plan and its executors."""
        self._bind_shred(shred)
        return self

    def _lanes(self) -> int:
        """Flat PTBERN's trial count (the join size); 0 for EXPRACE."""
        return self._join_size if self.method == "ptbern_flat" else 0

    # -- capacity planning ---------------------------------------------------
    @property
    def join_size(self) -> int:
        return self._join_size

    @property
    def route(self) -> str:
        """The bound draw route: 'fused', 'paged', 'reference' or
        'pernode'."""
        return self._route

    @property
    def draw_params(self) -> Optional[dict]:
        """The kernel draws' bound operand vectors (None on 'pernode')."""
        return self._dparams

    def expected_k(self) -> float:
        return float(estimate.expected_sample_size(self.w, self.p))

    def default_capacity(self) -> int:
        return self._default_cap

    def arrival_capacity(self) -> int:
        return self._arrival_cap

    # -- execution -----------------------------------------------------------
    def _call_overrides(self, spec: Optional[DrawSpec], cap, rep, acap):
        """Merge a per-call ``DrawSpec`` under the explicit kwargs."""
        if spec is not None:
            cap = cap or spec.cap
            acap = acap or spec.acap
            rep = rep or (spec.rep if spec.rep != "both" else None)
        return cap, rep, acap

    def sample(self, key, cap: Optional[int] = None, rep: Optional[str] = None,
               acap: Optional[int] = None,
               spec: Optional[DrawSpec] = None) -> JoinSample:
        """One independent Poisson sample draw (fresh randomness per key)."""
        cap, rep, acap = self._call_overrides(spec, cap, rep, acap)
        if self.p is None:
            raise ValueError("plan has no prob_var; use "
                             "uniform_sample/full_join")
        cap = cap or self.default_capacity()
        if self.join_size == 0:
            return executors.empty_sample(self.shred, cap)
        acap = acap or (self.arrival_capacity()
                        if self.method == "exprace" else 0)
        # An explicit per-call rep pins the per-node route: the fused and
        # paged routes have no rep (their kernels walk the arena).
        route = "pernode" if rep else self._route
        return self._run(self.shred, self.w, self.p, self.prefE, key,
                         cap=cap, rep=rep or self.rep_default,
                         n=self._lanes(), acap=acap,
                         narrow=self._narrow, route=route,
                         dparams=self._dparams if route != "pernode" else None,
                         policy=self.kernel_policy)

    def sample_batch(self, keys, cap: Optional[int] = None,
                     rep: Optional[str] = None, acap: Optional[int] = None,
                     spec: Optional[DrawSpec] = None) -> JoinSample:
        """``B`` independent Poisson draws in one dispatch. ``keys`` holds
        (B, 2) uint32 words (``threefry.keys``); the result's leaves carry
        a leading batch axis — columns/positions ``(B, cap)``,
        count/overflow ``(B,)`` — and lane ``b`` equals
        ``self.sample(keys[b])``. The keys are padded to their power-of-two
        bucket for the dispatch, and the padding lanes sliced off."""
        cap, rep, acap = self._call_overrides(spec, cap, rep, acap)
        if self.p is None:
            raise ValueError("plan has no prob_var; use "
                             "uniform_sample/full_join")
        kpad, batch = executors.pad_batch_keys(keys)
        cap = cap or self.default_capacity()
        if self.join_size == 0:
            return executors.empty_sample_batch(self.shred, cap, batch)
        acap = acap or (self.arrival_capacity()
                        if self.method == "exprace" else 0)
        route = "pernode" if rep else self._route  # an explicit rep pins it
        smp = self._run_batch(
            self.shred, self.w, self.p, self.prefE, kpad, cap=cap,
            rep=rep or self.rep_default, n=self._lanes(), acap=acap,
            narrow=self._narrow, route=route,
            dparams=self._dparams if route != "pernode" else None,
            policy=self.kernel_policy)
        if kpad.shape[0] != batch:
            smp = JoinSample({v: c[:batch] for v, c in smp.columns.items()},
                             smp.positions[:batch], smp.count[:batch],
                             smp.overflow[:batch])
        return smp

    def sample_auto(self, key, max_doublings: Optional[int] = None,
                    cap: Optional[int] = None, acap: Optional[int] = None,
                    spec: Optional[DrawSpec] = None) -> JoinSample:
        """Redraw with doubled capacity until no overflow (host loop)."""
        cap, _, acap = self._call_overrides(spec, cap, None, acap)
        if max_doublings is None:
            max_doublings = self.policy.max_doublings
        cap = cap or self.default_capacity()
        acap = acap or (self.arrival_capacity()
                        if self.method == "exprace" else 0)
        return redraw_with_doubling(
            lambda c, a: self.sample(key, cap=c, acap=a),
            cap, acap, max_doublings)

    def uniform_sample(self, key, p: float, cap: Optional[int] = None,
                       method: str = "hybrid") -> JoinSample:
        """beta_p with one fixed probability for every join tuple (paper
        §6.1): positions from the uniform sampler ``method``
        (hybrid/bern/geo/binom), then the plan's GET."""
        n = self.join_size
        if cap is None:
            cap = self.policy.uniform_capacity(n, p)
        if n == 0:
            return executors.empty_sample(self.shred, cap)
        ps = executors.uniform_positions_fn(method)(key, p, n, cap,
                                                    self.shred.device)
        pos = torch.clamp(ps.positions, max=n - 1)
        cols = probe.get(self.shred, pos, rep=self.rep_default,
                         policy=self.kernel_policy)
        return JoinSample(cols, ps.positions, ps.count, ps.overflow)

    def full_join(self, rep: Optional[str] = None,
                  spec: Optional[DrawSpec] = None) -> Dict[str, torch.Tensor]:
        """Yannakakis via the cached index: flatten mu* by bulk probe."""
        _, rep, _ = self._call_overrides(spec, None, rep, None)
        return flatten(self.shred, rep=rep or self.rep_default,
                       policy=self.kernel_policy)
