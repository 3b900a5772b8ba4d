"""A tiny schema-aware database: named relations with ordered columns, all
on one device. Snapshots are immutable; deltas (``apply``) are not ported
yet (ROADMAP queue A)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import resolve_device

from .jointree import Atom
from .relations import Relation

__all__ = ["Database"]


@dataclasses.dataclass
class Database:
    """relations: name -> Relation; schemas: name -> ordered column names.

    Atom variables bind positionally to the schema order, which is what
    makes self-joins (one relation, several aliases) work. ``version`` is
    the snapshot version the engine keys its caches by.
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
