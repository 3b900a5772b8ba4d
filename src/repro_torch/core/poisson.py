"""The result container of a Poisson sample. The ``PoissonSampler``
facade is not ported: callers hold a ``repro_torch.engine.QueryEngine``."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = ["JoinSample"]


@dataclasses.dataclass
class JoinSample:
    """A Poisson sample of the join result. Fixed capacity; lanes >= count
    are padding (mask with ``valid()``)."""

    columns: Dict[str, torch.Tensor]
    positions: torch.Tensor  # (cap,) flat offsets into the virtual join
    count: torch.Tensor      # () int64
    overflow: torch.Tensor   # () bool

    @property
    def capacity(self) -> int:
        return self.positions.shape[-1]

    def valid(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.positions.device)
                < self.count)
