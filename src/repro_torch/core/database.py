"""A tiny schema-aware database: named relations with ordered columns, all
on one device.

Snapshots are immutable and versioned: the only way to change data is
``Database.apply(delta)``, which returns a new snapshot with
``version + 1``. Untouched relations are shared by reference, so a delta
over one relation costs O(|that relation| + |delta|) on the device and
nothing for the rest of the database."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import resolve_device

from .delta import apply_relation_delta
from .jointree import Atom
from .relations import Relation

__all__ = ["Database"]


@dataclasses.dataclass
class Database:
    """relations: name -> Relation; schemas: name -> ordered column names.

    Atom variables bind positionally to the schema order, which is what
    makes self-joins (one relation, several aliases) work. ``version`` is
    the snapshot version the engine keys its caches by; it increases along
    an ``apply`` chain (per lineage, not globally).
    """

    relations: Dict[str, Relation]
    schemas: Dict[str, Tuple[str, ...]]
    device: torch.device
    version: int = 0

    @staticmethod
    def from_columns(tables: Mapping[str, Mapping[str, Sequence]],
                     device=None) -> "Database":
        """Build from numpy-convertible columns. ``device=None`` is the
        card (raises without one); pass ``device='cpu'`` for the CPU."""
        dev = resolve_device(device)
        rels, schemas = {}, {}
        for name, cols in tables.items():
            schemas[name] = tuple(cols.keys())
            rels[name] = Relation({
                c: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
                for c, v in cols.items()})
        return Database(rels, schemas, dev)

    def instance_for(self, atom: Atom) -> Relation:
        """The atom's relation with columns renamed to the atom's variables."""
        rel = self.relations[atom.relation]
        schema = self.schemas[atom.relation]
        if len(schema) != len(atom.variables):
            raise ValueError(
                f"atom {atom.name}: {len(atom.variables)} variables for "
                f"{len(schema)}-column relation {atom.relation}"
            )
        return Relation({v: rel.columns[c]
                         for c, v in zip(schema, atom.variables)})

    def size(self) -> int:
        """|db| = total number of tuples."""
        return sum(r.num_rows for r in self.relations.values())

    def apply(self, delta) -> "Database":
        """The next snapshot: ``delta`` (a ``core.delta.DeltaBatch``)
        applied to this one, on this database's device. Touched relations
        become "survivors then inserts" (``rows[~delete_mask] ++
        inserts``); untouched relations are shared by reference. Never
        mutates ``self``."""
        unknown = set(delta.relations) - set(self.relations)
        if unknown:
            raise KeyError(f"delta touches unknown relations {sorted(unknown)}")
        delta = delta.checked({n: r.num_rows
                               for n, r in self.relations.items()})
        rels = dict(self.relations)
        for name, d in delta.relations.items():
            d.validate(name, self.relations[name].num_rows, self.schemas[name])
            rels[name] = Relation(
                apply_relation_delta(self.relations[name].columns, d))
        return Database(rels, self.schemas, self.device, self.version + 1)
