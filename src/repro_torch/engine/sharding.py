"""Sharded execution as an engine path.

Two pieces:

  * ``plan_shards`` — the shard planner: picks the shard axes and count
    from the mesh shape, the root relation's size and the engine's
    ``CapacityPolicy`` (never over model-parallel axes, never below
    ``min_shard_rows`` root rows a shard);
  * ``ShardedPlan`` — the sharded counterpart of ``CompiledPlan``: the
    stacked per-shard indexes (``core.distributed.build_stacked``, held in
    the engine's shred cache) and one ``CompiledPlan`` a shard, which
    binds that shard's route, GET and draw tables on its device.

The reference runs its shards under ``shard_map``; the port is
single-controller: one host thread launches each shard's draw (or
flatten) on its shard's device through the shard's own plan, under the
shard-folded key ``fold_in(key, s)``, and the global count is the sum of
the shards' counts. The shards' outputs are then compacted into one
sample on the engine's device, positions rebased to global flat
coordinates, so a sharded sample compares with the single-device plan's.

The reference's ``lower_step`` (XLA lowering for its dry run) has no
meaning here and is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import DEFAULT_POLICY as DEFAULT_KERNEL_POLICY
from repro_torch.config import KernelPolicy
from repro_torch.core import estimate
from repro_torch.core.distributed import StackedShred
from repro_torch.core.jointree import JoinQuery
from repro_torch.core.poisson import JoinSample
from repro_torch.kernels import build, threefry

from . import executors
from .capacity import CapacityPolicy, DEFAULT_POLICY
from .plan import CompiledPlan, redraw_with_doubling
from .spec import DrawSpec

__all__ = ["ShardPlan", "ShardedPlan", "plan_shards", "BATCH_AXES"]

# Data-like mesh axes the root may be partitioned over; model-parallel
# axes replicate the index.
BATCH_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """The planner's verdict: which mesh axes shard the root, into how
    many blocks. ``axes == ()`` means "do not shard" (the single-device
    plan)."""

    axes: Tuple[str, ...]
    num_shards: int


def plan_shards(mesh, root_rows: int,
                policy: CapacityPolicy = DEFAULT_POLICY,
                axes: Optional[Tuple[str, ...]] = None) -> ShardPlan:
    """Pick shard axes and count from the mesh, the root's size and the
    policy. ``axes=None`` takes the mesh's data-like axes (``pod``,
    ``data``, or the sole axis of a single-axis mesh not named ``model``)
    and drops trailing axes while a shard would fall under
    ``policy.min_shard_rows`` root rows. An explicit ``axes`` is honored
    as it is. ``mesh`` needs only ``axis_names`` and ``shape``."""
    if axes is None:
        picked = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
        if not picked and len(mesh.axis_names) == 1 \
                and mesh.axis_names[0] != "model":
            picked = tuple(mesh.axis_names)

        def count(ax):
            return int(np.prod([mesh.shape[a] for a in ax])) if ax else 1

        while picked and count(picked) > 1 \
                and root_rows // count(picked) < policy.min_shard_rows:
            picked = picked[:-1]
        if count(picked) <= 1:
            return ShardPlan((), 1)
        return ShardPlan(picked, count(picked))
    axes = tuple(axes)
    n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    return ShardPlan(axes, n)


def _on(device: torch.device):
    """Make ``device`` current while a shard's launches are issued."""
    if device.type == "cuda":
        return build.on_device(device)
    return contextlib.nullcontext()


class ShardedPlan:
    """One sharded entry of the plan cache: the stacked index and a
    ``CompiledPlan`` a shard, keyed by (query fingerprint, rep, method,
    project, mesh shape, axes). Only ``exprace`` shards, as in the
    reference: flat PTBERN needs one trial count, and the shards' join
    sizes differ. A warm call builds nothing (``CacheStats``)."""

    def __init__(self, query: JoinQuery, spec: DrawSpec, mesh,
                 axes: Tuple[str, ...], stacked: StackedShred,
                 policy: CapacityPolicy = DEFAULT_POLICY,
                 kernel_policy: KernelPolicy = DEFAULT_KERNEL_POLICY,
                 device=None):
        if spec.method != "exprace":
            raise ValueError(f"sharded sampling supports method='exprace', "
                             f"got {spec.method!r}")
        self.query = query
        self.spec = spec  # the plan-identity spec (DrawSpec.plan_view)
        self.method = spec.method
        self.project = spec.project
        self.mesh = mesh
        self.axes = tuple(axes)
        self.policy = policy
        self.kernel_policy = kernel_policy
        self.device = torch.device(device) if device is not None \
            else stacked.devices[0]
        self.num_shards = int(np.prod([mesh.shape[a] for a in self.axes]))
        self.plans: List[CompiledPlan] = []
        self._bind_stacked(stacked)

    def _bind_stacked(self, stacked: StackedShred) -> None:
        """Bind the stack: each shard's plan binds (or rebinds) its index,
        which re-chooses its route, GET and draw tables; the capacities are
        the heaviest shard's and only grow."""
        if stacked.num_shards != self.num_shards:
            raise ValueError(f"{stacked.num_shards} shards for a mesh of "
                             f"{self.num_shards} over {self.axes}")
        self.stacked = stacked
        if self.plans:
            for plan, sh in zip(self.plans, stacked.shreds):
                with _on(sh.device):
                    plan.rebind_shred(sh)
        else:
            for sh in stacked.shreds:
                with _on(sh.device):
                    self.plans.append(CompiledPlan(
                        query=self.query, spec=self.spec, shred=sh,
                        policy=self.policy,
                        kernel_policy=self.kernel_policy))
        # Every shard with a join takes one route: one arena layout (or
        # none) for all, as _stack_shards keeps it.
        routes = {p.route for p in self.plans if p.join_size}
        if len(routes) > 1:
            raise AssertionError(f"shards took several routes: {routes}")
        self.route = routes.pop() if routes else self.plans[0].route
        self.rep = self.plans[0].rep_default
        self.join_sizes = stacked.join_sizes
        # Each shard's flat offset: the shards' flattens concatenate to the
        # global flatten, so base + local is the single-device coordinate.
        self._bases = np.concatenate(
            [[0], np.cumsum(self.join_sizes)])[:-1].astype(np.int64)
        if stacked.p is not None:
            stats = torch.tensor([
                [float(estimate.expected_sample_size(w, p)),
                 float(estimate.sample_std(w, p)),
                 float(estimate.exprace_arrival_mass(w, p))]
                for w, p in zip(stacked.w, stacked.p)], dtype=torch.float64)
            mean, std, mass = stats.max(0).values.tolist()
            mean, std, mass = max(mean, 0.0), max(std, 1.0), max(mass, 0.0)
            # One capacity for every shard, planned for the heaviest;
            # sticky across rebinds.
            self.cap = max(getattr(self, "cap", None) or 0,
                           self.policy.plan(mean, std))
            self.acap = max(getattr(self, "acap", 0),
                            self.policy.plan(mass * 1.1 + 8, mass ** 0.5))
        else:
            self.cap = None
            self.acap = 0

    def rebind_stacked(self, stacked: StackedShred) -> "ShardedPlan":
        """Swap in an (incrementally resharded) stack for a newer
        snapshot, keeping the shards' plans."""
        self._bind_stacked(stacked)
        return self

    # -- derived -------------------------------------------------------------
    @property
    def join_size(self) -> int:
        return self.stacked.join_size

    def expected_k(self) -> float:
        if self.stacked.p is None:
            raise ValueError("plan has no prob_var")
        return float(sum(float(estimate.expected_sample_size(w, p))
                         for w, p in zip(self.stacked.w, self.stacked.p)))

    def shard_keys(self, key) -> np.ndarray:
        """Each shard's key, (S, 2) words: ``key`` folded with the shard's
        linear index (``fold_shard_key`` of its coordinates; shard ``s``
        sits at index ``s``, ``Mesh.shard_coords``' order)."""
        words = np.asarray(threefry.key_words(key))[None]
        return threefry.fold_in_keys(words, range(self.num_shards))[:, 0]

    # -- execution -----------------------------------------------------------
    def _call_overrides(self, spec: Optional[DrawSpec], cap, acap):
        """A per-call ``DrawSpec`` under the explicit kwargs (kwargs win);
        only its runtime fields apply."""
        if spec is not None:
            cap = cap or spec.cap
            acap = acap or spec.acap
        return cap, acap

    def sample_step(self, key, cap: Optional[int] = None,
                    acap: Optional[int] = None
                    ) -> Tuple[Tuple[JoinSample, ...], torch.Tensor]:
        """One independent global Poisson sample, left on the devices: the
        shards' samples (shard-local positions, each on its device) and the
        global count (the sum of the shards', on the engine's device)."""
        if self.stacked.p is None:
            raise ValueError("plan has no prob_var; use full_join")
        cap, acap = cap or self.cap, acap or self.acap
        out = []
        for plan, k in zip(self.plans, self.shard_keys(key)):
            with _on(plan.shred.device):
                out.append(plan.sample(k, cap=cap, acap=acap))
        total = sum(s.count.to(self.device) for s in out)
        return tuple(out), total

    def sample(self, key, cap: Optional[int] = None,
               acap: Optional[int] = None,
               spec: Optional[DrawSpec] = None) -> JoinSample:
        """One independent Poisson sample, gathered into one sample on the
        engine's device: positions in global flat coordinates (shard base
        + local), columns of ``cap x shards`` lanes, the count of the
        gathered tuples, overflow if any shard overflowed."""
        cap, acap = self._call_overrides(spec, cap, acap)
        if self.stacked.p is None:
            raise ValueError("plan has no prob_var; use full_join")
        if self.join_size == 0:
            return _moved(executors.empty_sample(self.stacked.shreds[0],
                                                 cap or self.cap), self.device)
        shards, _ = self.sample_step(key, cap=cap, acap=acap)
        return self._gather(shards)

    def _gather(self, shards: Sequence[JoinSample]) -> JoinSample:
        """Compact the shards' (..., cap) buffers of one draw (or of B
        draws: leaves (B, cap)) into (..., cap x shards) lanes: shard 0's
        valid lanes, then shard 1's, ..., zeros after the count; positions
        rebased by each shard's flat offset. Shared by single and batched
        draws, so their lanes are equal."""
        dev = self.device
        lane_cap = shards[0].positions.shape[-1]
        lanes = torch.arange(lane_cap, device=dev)
        counts = torch.stack([torch.clamp(s.count.to(dev), max=lane_cap)
                              for s in shards])            # (S, ...)
        valid = torch.cat([lanes < c[..., None] for c in counts], -1)
        order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
        total = counts.sum(0)
        keep = torch.arange(valid.shape[-1], device=dev) < total[..., None]

        def compact(parts):
            x = torch.cat([p.to(dev) for p in parts], -1)
            x = torch.gather(x, -1, order)
            return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                    device=dev))

        cols = {v: compact([s.columns[v] for s in shards])
                for v in shards[0].columns}
        pos = compact([s.positions + int(b)
                       for s, b in zip(shards, self._bases)])
        overflow = torch.stack([s.overflow.to(dev) for s in shards]).any(0)
        return JoinSample(cols, pos, total, overflow)

    def sample_batch(self, keys, cap: Optional[int] = None,
                     acap: Optional[int] = None,
                     spec: Optional[DrawSpec] = None) -> JoinSample:
        """``B`` independent global draws: each shard draws the batch in
        one dispatch of its plan under the keys folded with its index, and
        lane ``b`` is gathered as ``sample(keys[b])`` gathers; so the lanes
        equal the single sharded draws. Leaves carry a leading batch axis."""
        cap, acap = self._call_overrides(spec, cap, acap)
        if self.stacked.p is None:
            raise ValueError("plan has no prob_var; use full_join")
        words = threefry.key_batch(keys)
        if self.join_size == 0:
            return _moved(executors.empty_sample_batch(
                self.stacked.shreds[0], cap or self.cap, words.shape[0]),
                self.device)
        cap, acap = cap or self.cap, acap or self.acap
        folded = threefry.fold_in_keys(words, range(self.num_shards))
        shards = []
        for plan, ks in zip(self.plans, folded):
            with _on(plan.shred.device):
                shards.append(plan.sample_batch(ks, cap=cap, acap=acap))
        return self._gather(shards)

    def sample_auto(self, key, max_doublings: Optional[int] = None,
                    cap: Optional[int] = None, acap: Optional[int] = None,
                    spec: Optional[DrawSpec] = None) -> JoinSample:
        """Redraw with doubled per-shard capacity until no shard
        overflows."""
        cap, acap = self._call_overrides(spec, cap, acap)
        return redraw_with_doubling(
            lambda c, a: self.sample(key, cap=c, acap=a),
            cap or self.cap, acap or self.acap,
            max_doublings if max_doublings is not None
            else self.policy.max_doublings)

    def full_join(self) -> Dict[str, torch.Tensor]:
        """Yannakakis through the stack: each shard flattens its block on
        its device, and the flattens concatenate, in shard order, to the
        single-device flatten, order included."""
        if self.join_size == 0:
            return {v: node.data.column(v)[:0].to(self.device)
                    for node in self.stacked.shreds[0].root.nodes()
                    for v in node.owned}
        parts = []
        for plan in self.plans:
            with _on(plan.shred.device):
                parts.append(plan.full_join())
        return {v: torch.cat([p[v].to(self.device) for p in parts])
                for v in parts[0]}


def _moved(smp: JoinSample, device: torch.device) -> JoinSample:
    return JoinSample({v: c.to(device) for v, c in smp.columns.items()},
                      smp.positions.to(device), smp.count.to(device),
                      smp.overflow.to(device))
