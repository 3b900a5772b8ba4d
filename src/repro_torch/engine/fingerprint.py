"""Stable fingerprints for queries and database schemas.

The compiled-plan cache is keyed by *structure*, never by data values: a
query fingerprint covers the atoms (relation, alias, variables) and
``prob_var``. Cache keys carry the bound snapshot's ``version`` as their
last element.
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from repro_torch.core.jointree import JoinQuery

__all__ = ["query_fingerprint", "plan_key", "executor_key"]


def _digest(payload: str) -> str:
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def query_fingerprint(query: JoinQuery) -> str:
    """Structure-only fingerprint of a join query (atom order matters: it is
    the GYO input order and fixes the canonical flatten order)."""
    atoms = tuple(
        (a.relation, a.alias or "", a.variables) for a in query.atoms
    )
    return _digest(repr((atoms, query.prob_var)))


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
