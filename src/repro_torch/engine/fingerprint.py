"""Stable fingerprints for queries and database schemas.

The compiled-plan cache is keyed by *structure*, never by data values: a
query fingerprint covers the atoms (relation, alias, variables) and
``prob_var``. Cache keys carry the bound snapshot's ``version`` as their
last element. Meshes are not ported yet (ROADMAP queue A): the draw
fingerprint keeps the reference's shape with ``None`` in their places.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from repro_torch.core.database import Database
from repro_torch.core.jointree import JoinQuery

__all__ = ["query_fingerprint", "schema_fingerprint", "plan_key",
           "executor_key", "draw_fingerprint"]


def _digest(payload: str) -> str:
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def query_fingerprint(query: JoinQuery) -> str:
    """Structure-only fingerprint of a join query (atom order matters: it is
    the GYO input order and fixes the canonical flatten order)."""
    atoms = tuple(
        (a.relation, a.alias or "", a.variables) for a in query.atoms
    )
    return _digest(repr((atoms, query.prob_var)))


def schema_fingerprint(db: Database) -> str:
    """Shape/dtype fingerprint of the database instance (no data values)."""
    rels = []
    for name in sorted(db.relations):
        rel = db.relations[name]
        cols = tuple(
            (c, str(rel.columns[c].dtype), int(rel.columns[c].shape[0]))
            for c in sorted(rel.columns)
        )
        rels.append((name, db.schemas.get(name, ()), cols))
    return _digest(repr(tuple(rels)))


def plan_key(query: JoinQuery, rep: str, version: int = 0) -> Tuple[str, str, int]:
    """Cache key of a shred index: query structure x representation x the
    bound snapshot version."""
    return (query_fingerprint(query), rep, version)


def executor_key(
    query: JoinQuery, rep: str, method: str,
    project: Optional[Tuple[str, ...]], version: int = 0,
    narrow: Optional[bool] = None, kernels: str = "auto",
) -> Tuple:
    """Cache key of a compiled plan: the shred key plus every plan-identity
    field of the ``DrawSpec``; the snapshot version stays last."""
    return (query_fingerprint(query), rep, method, project, narrow, kernels,
            version)


def draw_fingerprint(spec) -> Tuple:
    """Structure-only fingerprint of a ``DrawSpec``: hashable and stable.
    The last two places are the reference's mesh shape and axes, ``None``
    until meshes are ported."""
    return (spec.rep, spec.method, spec.project, spec.narrow, spec.kernels,
            spec.cap, spec.acap, None, None)
