"""Delta batches: the unit of change between database snapshots.

The model is immutable versioned snapshots, as in the reference:

  * a ``Database`` never mutates — ``Database.apply(delta)`` produces a new
    snapshot (version + 1) sharing every untouched relation's tensors;
  * a ``DeltaBatch`` describes one transition: per-relation row inserts
    (appended after the surviving rows) and per-relation delete masks
    (boolean, True = delete);
  * the post-delta layout is canonical — surviving rows keep their
    relative order, inserts follow — which is what lets
    ``shred.reshred_incremental`` merge a delta into an existing sorted
    grouping and still equal a build from scratch.

Deltas are host-side numpy objects: their own arrays are small, and each
is uploaded to the database's device once, where it is applied. Row-index
deletes stay indices until they reach the device (``checked``,
``keep_tensor``): a relation-sized mask is built there, not on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["DeltaBatch", "RelationDelta", "apply_relation_delta"]


@dataclasses.dataclass(frozen=True)
class RelationDelta:
    """Changes to one relation: a delete mask over the current rows plus
    rows to insert (column name -> 1-D numpy array, all equal length).

    ``delete_mask`` is None when nothing is deleted; ``inserts`` is an empty
    dict when nothing is inserted. Either side may be empty, not both.
    """

    delete_mask: Optional[np.ndarray] = None
    inserts: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_deletes(self) -> int:
        if self.delete_mask is None:
            return 0
        if self.delete_mask.dtype == np.bool_:
            return int(self.delete_mask.sum())
        return int(self.delete_mask.shape[0])  # index form (pre-resolution)

    @property
    def num_inserts(self) -> int:
        if not self.inserts:
            return 0
        return int(next(iter(self.inserts.values())).shape[0])

    def validate(self, name: str, num_rows: int,
                 schema: Tuple[str, ...]) -> None:
        """Check the delta against its relation. Deletes are a boolean mask
        over the rows, or row indices that ``DeltaBatch.checked`` passed."""
        mask = self.delete_mask
        if mask is not None and mask.dtype != np.int64:  # indices: checked
            if mask.dtype != np.bool_:
                raise ValueError(f"{name}: delete_mask must be boolean, "
                                 f"got {mask.dtype}")
            if mask.shape != (num_rows,):
                raise ValueError(
                    f"{name}: delete_mask has shape {self.delete_mask.shape}, "
                    f"relation has {num_rows} rows")
        if self.inserts:
            if set(self.inserts) != set(schema):
                raise ValueError(
                    f"{name}: insert columns {sorted(self.inserts)} != "
                    f"schema columns {sorted(schema)}")
            lens = {c: v.shape[0] for c, v in self.inserts.items()}
            if len(set(lens.values())) > 1:
                raise ValueError(f"{name}: ragged insert columns {lens}")
        if self.delete_mask is None and not self.inserts:
            raise ValueError(f"{name}: empty relation delta (no deletes, "
                             f"no inserts)")


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One atomic multi-relation change set: relation name -> RelationDelta.

    Build with ``DeltaBatch.of`` or the raw constructor. ``Database.apply``
    yields a new snapshot whose touched relations are "survivors then
    inserts" (``rows' = rows[~delete_mask] ++ inserts``); relations not
    named in the batch are shared by reference with the previous snapshot.

    ``lsn`` is the batch's log sequence number once a replicated delta log
    has appended it (1-based; ``None`` for free-standing deltas): along a
    log, ``snapshot.version == base_version + lsn``.
    """

    relations: Dict[str, RelationDelta]
    lsn: Optional[int] = None

    def __post_init__(self):
        if not self.relations:
            raise ValueError("DeltaBatch must touch at least one relation")

    def with_lsn(self, lsn: int) -> "DeltaBatch":
        """The same batch stamped with a log sequence number."""
        if self.lsn is not None and self.lsn != lsn:
            raise ValueError(f"delta already has lsn={self.lsn}, "
                             f"refusing to restamp as {lsn}")
        return dataclasses.replace(self, lsn=lsn)

    @staticmethod
    def of(**per_relation) -> "DeltaBatch":
        """Convenience constructor::

            DeltaBatch.of(
                R={"insert": {"x": [1, 2], "p": [0.3, 0.4]}},
                S={"delete": [0, 5]},          # row indices
            )

        ``delete`` accepts row indices or a boolean mask; ``insert`` is a
        column mapping. Index deletes are resolved against the relation's
        row count when the batch is applied.
        """
        rels = {}
        for name, spec in per_relation.items():
            ins = {c: np.asarray(v) for c, v in spec.get("insert", {}).items()}
            dele = spec.get("delete", None)
            mask = None
            if dele is not None:
                dele = np.asarray(dele)
                if dele.dtype == np.bool_:
                    mask = dele
                else:  # row indices: length is validated when resolved
                    mask = dele.astype(np.int64)
            rels[name] = RelationDelta(delete_mask=mask, inserts=ins)
        return DeltaBatch(rels)

    def touched(self) -> Tuple[str, ...]:
        """Names of the relations this batch modifies."""
        return tuple(sorted(self.relations))

    def size(self) -> int:
        """|delta| = total rows inserted + deleted."""
        return sum(d.num_deletes + d.num_inserts
                   for d in self.relations.values())

    def resolved(self, num_rows: Mapping[str, int]) -> "DeltaBatch":
        """Index-style delete specs as boolean masks over the given row
        counts (the reference's resolved form).

        Out-of-range indices (negative ones included: no wraparound) and
        duplicate indices are errors, so ``num_deletes`` and ``size()``
        agree with what an apply removes."""
        return self._resolve(num_rows, masks=True)

    def checked(self, num_rows: Mapping[str, int]) -> "DeltaBatch":
        """``resolved``'s checks with index deletes left as int64 indices:
        the form ``Database.apply`` and ``reshred_incremental`` take to
        the device, where ``keep_tensor`` turns them into a mask."""
        return self._resolve(num_rows, masks=False)

    def _resolve(self, num_rows: Mapping[str, int],
                 masks: bool) -> "DeltaBatch":
        rels = {}
        for name, d in self.relations.items():
            mask = d.delete_mask
            if mask is not None and mask.dtype != np.bool_:
                n = num_rows[name]
                if mask.size and (mask.min() < 0 or mask.max() >= n):
                    raise ValueError(
                        f"{name}: delete indices out of range [0, {n}): "
                        f"{mask[(mask < 0) | (mask >= n)][:5].tolist()}")
                # a sort: np.unique's hash path was the slowest step of an
                # update at JOB scale
                srt = np.sort(mask)
                if (srt[1:] == srt[:-1]).any():
                    raise ValueError(f"{name}: duplicate delete indices")
                if masks:
                    m = np.zeros((n,), np.bool_)
                    m[mask] = True
                    mask = m
            rels[name] = RelationDelta(delete_mask=mask, inserts=d.inserts)
        return DeltaBatch(rels, lsn=self.lsn)


def keep_tensor(d: RelationDelta, num_rows: int,
                device) -> Optional[torch.Tensor]:
    """The survivors' mask of a checked delta over ``num_rows`` rows, on
    ``device``, or ``None`` when it deletes nothing: a boolean mask is
    uploaded as it is; row indices are uploaded and scattered into a mask
    made on the device."""
    if d.delete_mask is None:
        return None
    if d.delete_mask.dtype == np.bool_:
        return torch.from_numpy(~d.delete_mask).to(device)
    keep = torch.ones((num_rows,), dtype=torch.bool, device=device)
    keep[torch.from_numpy(d.delete_mask).to(device)] = False
    return keep


def apply_relation_delta(columns: Dict[str, torch.Tensor], d: RelationDelta,
                         keep: Optional[torch.Tensor] = None
                         ) -> Dict[str, torch.Tensor]:
    """Survivors-then-inserts column transform (the canonical layout) of a
    checked delta, on the columns' device; each insert array is uploaded
    once, cast to its column's dtype. ``keep`` is the survivors' mask
    already on the device (``keep_tensor``), if the caller holds it."""
    out = {}
    if keep is None and d.delete_mask is not None:
        col = next(iter(columns.values()))
        keep = keep_tensor(d, col.shape[0], col.device)
    for c, v in columns.items():
        nv = v[keep] if keep is not None else v
        if d.inserts:
            ins = torch.as_tensor(np.ascontiguousarray(d.inserts[c]))
            nv = torch.cat([nv, ins.to(device=nv.device, dtype=nv.dtype)])
        out[c] = nv
    return out
