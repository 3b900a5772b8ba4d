"""Explicit capacity / overflow policy for fixed-capacity sampling.

Every sampler draws into a fixed-capacity buffer and reports ``(count,
overflow)``. This policy owns the headroom over the expected sample size
(``sigmas`` standard deviations + ``slack`` lanes, rounded up to a lane
multiple), the EXPRACE arrival-scratch size, and the redraw-on-overflow
bound. The defaults are the reference's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import estimate

__all__ = ["CapacityPolicy", "DEFAULT_POLICY"]


@dataclasses.dataclass(frozen=True)
class CapacityPolicy:
    """Capacity planning knobs for one engine instance.

    sigmas:         headroom in standard deviations (6 -> P(overflow) ~ 1e-9).
    slack:          additive lane slack on top of the sigma headroom.
    lane_multiple:  round capacities up to this multiple.
    max_doublings:  redraw attempts in auto mode before giving up.
    min_shard_rows: the shard planner never splits the root relation below
                    this many rows a shard: finer splits are all padding
                    and no work.
    """

    sigmas: float = 6.0
    slack: int = 64
    lane_multiple: int = 128
    max_doublings: int = 8
    min_shard_rows: int = 8

    def plan(self, mean: float, std: float) -> int:
        return estimate.plan_capacity(
            float(mean), float(std), sigmas=self.sigmas, slack=self.slack,
            multiple=self.lane_multiple,
        )

    def sample_capacity(self, w, p) -> int:
        """Output capacity for a Poisson sample with per-root (w, p)."""
        mean = estimate.expected_sample_size(w, p)
        std = estimate.sample_std(w, p)
        return self.plan(float(mean), float(std))

    def arrival_capacity(self, w, p) -> int:
        """Scratch capacity for EXPRACE's raw Poisson arrivals."""
        mass = float(estimate.exprace_arrival_mass(w, p))
        return self.plan(mass, mass**0.5)

    def uniform_capacity(self, n: int, p: float) -> int:
        """Capacity for a uniform beta_p sample over n positions."""
        mean = n * p
        return self.plan(mean, (mean * max(1.0 - p, 0.0)) ** 0.5)

    def flatten_capacity(self, max_shard_join: int) -> int:
        """Static per-shard probe capacity for a sharded full join: the
        largest shard's join size, lane-rounded (the reference's; the
        port's sharded full join concatenates each shard's join at its own
        size and needs no such cap)."""
        return estimate.round_up(max(int(max_shard_join), 1),
                                 self.lane_multiple)


DEFAULT_POLICY = CapacityPolicy()
