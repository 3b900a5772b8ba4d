"""End-to-end Poisson sampling queries via Index-and-Probe (paper §3).

    sampler = PoissonSampler(db, query)         # (1) build random-access index
    sample  = sampler.sample(key)               # (2) position-sample (3) probe

``JoinSample`` is the result of every draw. ``PoissonSampler`` is a thin
facade over ``repro_torch.engine.QueryEngine``: it compiles one plan on a
private engine and delegates every call, so its results equal
``engine.sample`` under the same key. New code should hold a
``QueryEngine``, which shares its caches across queries and batches draws.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

import torch

from repro_torch.config import KernelPolicy

from .database import Database
from .jointree import JoinQuery

__all__ = ["JoinSample", "PoissonSampler"]


@dataclasses.dataclass
class JoinSample:
    """A Poisson sample of the join result. Fixed capacity; lanes >= count
    are padding (mask with ``valid()``).

    Batched draws (``sample_batch``) use the same container with a leading
    batch axis on every tensor: columns/positions ``(B, cap)``,
    count/overflow ``(B,)``. ``capacity`` is the last axis and ``valid()``
    broadcasts the per-draw counts, so masking code works on either
    layout."""

    columns: Dict[str, torch.Tensor]
    positions: torch.Tensor  # (cap,) or (B, cap) flat offsets into the join
    count: torch.Tensor      # () or (B,) int64
    overflow: torch.Tensor   # () or (B,) bool

    @property
    def capacity(self) -> int:
        return self.positions.shape[-1]

    @property
    def batch(self) -> Optional[int]:
        """Leading batch size of a batched sample, else None."""
        return self.positions.shape[0] if self.positions.dim() == 2 else None

    def valid(self) -> torch.Tensor:
        count = self.count
        if count.dim():
            count = count[..., None]
        return (torch.arange(self.capacity, device=self.positions.device)
                < count)


class PoissonSampler:
    """Index-and-Probe executor for ``Q = beta_y(R1 |><| ... |><| Rl)`` on
    the database's device.

    .. deprecated::
        Thin facade over ``repro_torch.engine.QueryEngine`` (one engine,
        one compiled plan). Construct a ``QueryEngine`` instead — it
        caches plans across queries and batches draws (``sample_batch``).
    """

    def __init__(self, db: Database, query: JoinQuery, rep: str = "usr",
                 method: str = "exprace", project: Optional[tuple] = None,
                 kernel_policy: Optional[KernelPolicy] = None):
        """``project``: bag-projection attributes A of beta_y(pi_A(Q^))
        (eq. 2); y must be in A, and the sample's columns are restricted
        to A."""
        from repro_torch.engine import QueryEngine  # engine imports core

        warnings.warn(
            "core.PoissonSampler is deprecated; use "
            "repro_torch.engine.QueryEngine (engine.sample / "
            "engine.sample_batch) — it shares plan caches across queries "
            "and supports batching",
            DeprecationWarning, stacklevel=2)
        if query.prob_var is None:
            raise ValueError("Poisson sampling needs query.prob_var (beta_y)")
        if project is not None and query.prob_var not in project:
            raise ValueError("prob_var (y) must be in the projection A")
        self.engine = QueryEngine(db, rep=rep, kernel_policy=kernel_policy,
                                  device=db.device)
        self._plan = self.engine.compile(query, rep=rep, method=method,
                                         project=project)
        self.project = self._plan.project
        self.query = query
        self.rep_default = self._plan.rep_default
        self.method = method
        self.shred = self._plan.shred
        self.w = self._plan.w
        self.p = self._plan.p
        self.prefE = self._plan.prefE

    # -- capacity planning ---------------------------------------------------
    @property
    def join_size(self) -> int:
        return self._plan.join_size

    def expected_k(self) -> float:
        return self._plan.expected_k()

    def default_capacity(self) -> int:
        return self._plan.default_capacity()

    def arrival_capacity(self) -> int:
        return self._plan.arrival_capacity()

    # -- sampling ------------------------------------------------------------
    def sample(self, key, cap: Optional[int] = None, rep: Optional[str] = None,
               acap: Optional[int] = None) -> JoinSample:
        return self._plan.sample(key, cap=cap, rep=rep, acap=acap)

    def sample_auto(self, key, max_doublings: int = 8) -> JoinSample:
        """Redraw with doubled capacity until no overflow (host loop)."""
        return self._plan.sample_auto(key, max_doublings=max_doublings)

    def uniform_sample(self, key, p: float, cap: Optional[int] = None,
                       method: str = "hybrid") -> JoinSample:
        """beta_p with a fixed uniform probability (paper §6.1)."""
        return self._plan.uniform_sample(key, p, cap=cap, method=method)
