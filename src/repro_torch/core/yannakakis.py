"""Full acyclic join processing and the Materialize-and-Scan baselines.

The same index that backs Poisson sampling computes full joins by probing
every position — the paper's "single engine basis" point (§6.3).

Baselines (paper §6 "Baseline"):
  M-USYA : build the USR index, flatten, per-tuple Bernoulli
           (``materialize_and_scan``; the CSR index is not ported yet,
           ROADMAP queue A).
  M-BJ   : pairwise materializing sort-merge joins (``binary_join``), as
           in the reference, every intermediate materialized.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy

from . import probe
from .database import Database
from .jointree import JoinQuery, JoinTreeNode, gyo_join_tree
from .relations import Relation, dense_keys
from .sampling import generators
from .shred import Shred, build_shred

__all__ = ["flatten", "full_join", "materialize_and_scan", "binary_join"]

I64 = torch.int64


def flatten(shred: Shred, rep: Optional[str] = None,
            policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    """mu*(N): materialize the full join from the index by probing every
    position, in the canonical flatten order."""
    n = int(shred.join_size)
    if n == 0 or shred.root.num_rows == 0:
        return {v: node.data.column(v)[:0]
                for node in shred.root.nodes() for v in node.owned}
    pos = torch.arange(n, dtype=I64, device=shred.device)
    return probe.get(shred, pos, rep=rep, policy=policy)


def full_join(db: Database, query: JoinQuery,
              rep: str = "usr") -> Dict[str, torch.Tensor]:
    """Yannakakis via shredded semijoins + flatten (SYA; Prop 4.4/4.5), on
    the database's device.

    .. deprecated::
        Facade over ``QueryEngine.full_join`` (one throwaway engine — the
        index is rebuilt every call). Hold a ``QueryEngine`` instead so
        the index is cached across calls."""
    from repro_torch.engine import QueryEngine  # engine imports core

    warnings.warn(
        "core.yannakakis.full_join is deprecated; use "
        "repro_torch.engine.QueryEngine.full_join — it caches the shred "
        "index across calls instead of rebuilding it per query",
        DeprecationWarning, stacklevel=2)
    return QueryEngine(db, rep=rep, device=db.device).full_join(query)


def materialize_and_scan(
    key, db: Database, query: JoinQuery, uniform_p: Optional[float] = None,
    rep: str = "usr", policy: KernelPolicy = DEFAULT_POLICY,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The naive M&S algorithm: materialize |Q^(db)| tuples, Bernoulli
    each with a float64 uniform of the key's stream.

    Returns (full join columns, keep mask); the sample is cols[mask]. Kept
    un-compacted so callers can compare against I&P samples exactly.
    """
    shred = build_shred(db, query, rep=rep, policy=policy)
    get_rep, _ = probe.select_rep(shred, "usr", policy)
    cols = flatten(shred, rep=get_rep, policy=policy)
    n = int(shred.join_size)
    if uniform_p is not None:
        pflat = torch.full((n,), float(uniform_p), dtype=torch.float64,
                           device=db.device)
    else:
        assert query.prob_var is not None
        pflat = cols[query.prob_var].to(torch.float64)
    u = torch.rand((max(n, 1),), dtype=torch.float64, device=db.device,
                   generator=generators(key, db.device)[1])
    return cols, u[:n] < pflat


# ---------------------------------------------------------------------------
# M-BJ: pairwise materializing binary joins
# ---------------------------------------------------------------------------

def _pairwise_join(left: Relation, right: Relation) -> Relation:
    """Materializing sort-merge equi-join on the shared variables, in the
    reference's output order: left rows in order, each with its run of
    matching right rows in stable key order. The output size is
    data-dependent (one host read), exactly why the paper replaces this
    plan shape with the index."""
    shared = sorted(set(left.columns) & set(right.columns))
    m, n = left.num_rows, right.num_rows
    dev = next(iter(left.columns.values())).device
    if shared:
        kl, kr = dense_keys([left.column(v) for v in shared],
                            [right.column(v) for v in shared])
    else:
        kl = torch.zeros((m,), dtype=I64, device=dev)
        kr = torch.zeros((n,), dtype=I64, device=dev)
    order = torch.argsort(kr, stable=True)
    kr_sorted = kr[order]
    s = torch.searchsorted(kr_sorted, kl, right=False)
    counts = torch.searchsorted(kr_sorted, kl, right=True) - s
    # Expand: output row t pairs left row lrow[t] with the (t - base)-th
    # element of its run in the sorted right side.
    lrow = torch.repeat_interleave(torch.arange(m, device=dev), counts)
    base = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rpos = s[lrow] + torch.arange(lrow.shape[0], device=dev) - base
    rrow = order[rpos]
    out = {v: left.column(v)[lrow] for v in sorted(left.columns)}
    for v in sorted(right.columns):
        if v not in out:
            out[v] = right.column(v)[rrow]
    return Relation(out)


def binary_join(db: Database, query: JoinQuery) -> Dict[str, torch.Tensor]:
    """M-BJ plan: join along the join tree bottom-up, materializing every
    intermediate (join order = post-order of the GYO tree)."""
    tree = gyo_join_tree(query)

    def rec(node: JoinTreeNode) -> Relation:
        rel = db.instance_for(node.atom)
        for c in node.children:
            rel = _pairwise_join(rel, rec(c))
        return rel

    return dict(rec(tree).columns)
