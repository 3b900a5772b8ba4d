"""Column-store relations (struct-of-arrays) on torch tensors.

A relation is a mapping ``attribute -> 1-D tensor``, all of equal length,
all on one device. Tuples are addressed positionally (offset i), like the
paper's ``R[i](ybar)`` notation. Dangling tuples are kept with weight zero
by the index build rather than compacted, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import resolve_device

__all__ = ["Relation", "pack_keys", "dense_keys"]


@dataclasses.dataclass(frozen=True)
class Relation:
    """An immutable column-store relation.

    columns: mapping attribute name -> tensor of shape (n,).
    """

    columns: Dict[str, torch.Tensor]

    @property
    def attrs(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    @property
    def num_rows(self) -> int:
        if not self.columns:
            return 0
        return next(iter(self.columns.values())).shape[0]

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def project(self, attrs: Sequence[str]) -> "Relation":
        return Relation({a: self.columns[a] for a in attrs})

    def rename(self, mapping: Mapping[str, str]) -> "Relation":
        return Relation({mapping.get(a, a): v for a, v in self.columns.items()})

    def take(self, rows: torch.Tensor) -> "Relation":
        """Gather rows (positional); rows may repeat (bag semantics)."""
        return Relation({a: v[rows] for a, v in self.columns.items()})

    def concat(self, other: "Relation") -> "Relation":
        assert set(self.columns) == set(other.columns)
        return Relation({a: torch.cat([self.columns[a], other.columns[a]])
                         for a in self.columns})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {a: v.cpu().numpy() for a, v in self.columns.items()}

    @staticmethod
    def from_numpy(cols: Mapping[str, np.ndarray], device=None) -> "Relation":
        """Columns from numpy arrays, on ``device`` (the card by
        default)."""
        device = resolve_device(device)
        return Relation({a: torch.as_tensor(np.asarray(v), device=device)
                         for a, v in cols.items()})

    def validate(self) -> None:
        lens = {v.shape[0] for v in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(
                f"ragged columns: { {a: tuple(v.shape) for a, v in self.columns.items()} }")


def pack_keys(cols: Sequence[torch.Tensor], radices: Sequence[int]
              ) -> torch.Tensor:
    """Pack multi-attribute integer keys into one int64 via mixed radix
    (the first column most significant). ``radices[i]`` must strictly
    exceed every value of ``cols[i]``."""
    assert len(cols) == len(radices) and cols
    key = cols[0].to(torch.int64)
    for c, r in zip(cols[1:], radices[1:]):
        key = key * int(r) + c.to(torch.int64)
    return key


def dense_keys(left: Sequence[torch.Tensor], right: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map multi-column join keys of two relations to one dense int64 id.

    The same attribute tuple receives the same id on both sides. The ids
    are the reference's: the dense rank of each distinct tuple in lexsort
    order, LAST column primary. Torch has no ``lexsort``, so stable
    argsorts are chained from the first column to the last — the last
    sort decides first, exactly like lexsort's key order.
    """
    assert len(left) == len(right) and left
    m = left[0].shape[0]
    cols = [torch.cat([l.to(torch.int64), r.to(torch.int64)])
            for l, r in zip(left, right)]
    order = torch.arange(cols[0].shape[0], device=cols[0].device)
    for c in cols:
        order = order[torch.argsort(c[order], stable=True)]
    sorted_cols = [c[order] for c in cols]
    diff = torch.zeros(sorted_cols[0].shape, dtype=torch.bool,
                       device=order.device)
    for c in sorted_cols:
        head = torch.ones((1,), dtype=torch.bool, device=order.device)
        diff = diff | torch.cat([head, c[1:] != c[:-1]])[:c.shape[0]]
    gid_sorted = torch.cumsum(diff.to(torch.int64), 0) - 1
    gid = torch.empty_like(gid_sorted)
    gid[order] = gid_sorted
    return gid[:m], gid[m:]
