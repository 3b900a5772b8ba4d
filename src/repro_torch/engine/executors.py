"""The sample executor behind the engine's Poisson entry point.

One executor is a plain callable with ``(method, project)`` bound; the
plan keeps it for its lifetime. PyTorch runs eagerly, so there is no trace
to cache: a warm draw is the executor call itself. Batched draws
(``sample_batch``) are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy
from repro_torch.core import probe, sampling
from repro_torch.core.poisson import JoinSample
from repro_torch.core.shred import Shred

__all__ = ["sample_executor", "empty_sample"]


def _sample(shred: Shred, w, p, prefE, key, cap: int, rep: str, method: str,
            n: int = 0, acap: int = 0, project=None, narrow: bool = False,
            route: str = "pernode", dparams=None,
            policy: KernelPolicy = DEFAULT_POLICY) -> JoinSample:
    if route in ("fused", "reference"):
        # One-launch draw: positions AND per-node rows come out of one
        # kernel (or its plain version); only the column gather remains.
        node_rows, ps = probe.draw_fused(
            shred, dparams, key, method=method, cap=cap, acap=acap, n=n,
            reference=(route == "reference"))
        cols = probe.gather_columns(shred, node_rows)
    elif route == "paged":
        # The sampling launch, then the walk page by page.
        node_rows, ps = probe.draw_paged(shred, dparams, key, method=method,
                                         cap=cap, acap=acap, n=n)
        cols = probe.gather_columns(shred, node_rows)
    else:
        if method == "exprace":
            ps = sampling.exprace_positions(
                key, w, p, prefE, cap, arrival_cap=acap,
                pref32=shred.root_pref32 if narrow else None, policy=policy)
        elif method == "ptbern_flat":  # n is the join size
            ps = sampling.pt_bern_flat_positions(key, p, prefE, n, cap)
        else:
            raise ValueError(f"unknown sampling method {method!r}")
        pos = torch.minimum(ps.positions, torch.clamp(prefE[-1] - 1, min=0))
        cols = probe.get(shred, pos, rep=rep, policy=policy)
    if project is not None:
        cols = {v: c for v, c in cols.items() if v in project}
    return JoinSample(cols, ps.positions, ps.count, ps.overflow)


def sample_executor(method: str, project: Optional[tuple]):
    """The Poisson-sample executor with (method, project) bound."""
    return partial(_sample, method=method, project=project)


def empty_sample(shred: Shred, cap: int) -> JoinSample:
    """An all-padding sample (used when |Q(db)| == 0: nothing to probe)."""
    dev = shred.device
    cols = {v: torch.zeros((cap,), dtype=node.data.column(v).dtype, device=dev)
            for node in shred.root.nodes() for v in node.owned}
    return JoinSample(cols, torch.zeros((cap,), dtype=torch.int64, device=dev),
                      torch.zeros((), dtype=torch.int64, device=dev),
                      torch.zeros((), dtype=torch.bool, device=dev))
