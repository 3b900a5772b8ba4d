"""``DrawSpec`` — one frozen description of how a query executes.

  * **frozen + hashable** — a spec can key dictionaries and land in
    plan-cache keys;
  * **structure vs runtime** — ``rep``/``method``/``project``/``narrow``/
    ``kernels`` are *plan identity* (part of the plan cache key via
    ``fingerprint.executor_key``); ``cap``/``acap`` are runtime values and
    ``mesh``/``axes`` route to the sharded plan;
  * **None = inherit** — every field defaults to "use the engine/plan
    default", so ``DrawSpec()`` is the no-kwargs call.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["DrawSpec", "merge_spec"]

_REPS = (None, "csr", "usr", "both")
_METHODS = ("exprace", "ptbern_flat")
_KERNELS = ("auto", "fused", "paged", "pernode", "reference")


@dataclasses.dataclass(frozen=True)
class DrawSpec:
    """How a draw (or full join) executes. All fields optional; ``None``
    means "inherit the engine/plan default".

    rep      index representation (``csr``/``usr``/``both``); None lets
             the plan pick (the engine default, upgraded to the fused GET
             kernel when available — an explicit rep always wins).
    method   position-sampling method for Poisson draws (``exprace`` or
             ``ptbern_flat``; default exprace).
    project  bag-projection attributes A for beta_y(pi_A(Q^)) queries.
    cap      sample capacity override (never a new plan).
    acap     EXPRACE arrival-scratch capacity override.
    narrow   int32-narrowed sampler searches: None = auto (on iff the index
             packed an int32 arena and kernels are preferred), True = force
             on (requires a packed index), False = force off.
    kernels  draw route: ``auto`` = the one-launch fused draw iff capable
             and the ``KernelPolicy`` prefers it, else the paged draw
             under the same gates, else the per-node route; ``fused`` =
             require the fused kernel (raises at bind if unavailable);
             ``paged`` = require the paged draw (raises unless the index
             is in the paged regime); ``reference`` = the fused pipeline
             as plain torch ops; ``pernode`` = always the float64
             per-node route.
    mesh     device mesh (``launch.mesh.Mesh``): route through the sharded
             plan.
    axes     mesh axes to partition the root over (None = shard planner).
    """

    rep: Optional[str] = None
    method: str = "exprace"
    project: Optional[Tuple[str, ...]] = None
    cap: Optional[int] = None
    acap: Optional[int] = None
    narrow: Optional[bool] = None
    kernels: str = "auto"
    mesh: Optional[object] = None
    axes: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        # Normalize sequence-typed fields so equal specs hash equal.
        if self.project is not None and not isinstance(self.project, tuple):
            object.__setattr__(self, "project", tuple(self.project))
        if self.axes is not None and not isinstance(self.axes, tuple):
            object.__setattr__(self, "axes", tuple(self.axes))
        if self.rep not in _REPS:
            raise ValueError(
                f"rep must be csr|usr|both|None, got {self.rep!r}")
        if self.method not in _METHODS:
            raise ValueError(
                f"method must be one of {_METHODS}, got {self.method!r}")
        if self.kernels not in _KERNELS:
            raise ValueError(
                f"kernels must be one of {_KERNELS}, got {self.kernels!r}")

    # -- derived views -------------------------------------------------------
    def plan_view(self, rep: str) -> "DrawSpec":
        """The spec a ``CompiledPlan`` stores: plan-identity fields only,
        with ``rep`` pinned to the concrete representation the index was
        built with. Runtime fields (cap/acap) and routing fields
        (mesh/axes) are stripped."""
        return DrawSpec(rep=rep, method=self.method, project=self.project,
                        narrow=self.narrow, kernels=self.kernels)

    def with_overrides(self, **kw) -> "DrawSpec":
        """``dataclasses.replace`` restricted to non-None overrides —
        the merge rule of the legacy-kwargs shim."""
        return merge_spec(self, **kw)


def merge_spec(spec: Optional[DrawSpec], **kw) -> DrawSpec:
    """The one normalization rule behind every entry point's legacy
    kwargs: start from ``spec`` (or an empty ``DrawSpec``) and overlay
    every kwarg that was explicitly passed (i.e. is not None)."""
    base = spec if spec is not None else DrawSpec()
    over = {k: v for k, v in kw.items() if v is not None}
    return dataclasses.replace(base, **over) if over else base
