"""Full acyclic join processing from the shredded index (flatten mu*).

The same index that backs Poisson sampling computes full joins by probing
every position — the paper's "single engine basis" point (§6.3). The
Materialize-and-Scan baselines and the pairwise join are not ported yet
(ROADMAP queue A).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy

from . import probe
from .shred import Shred

__all__ = ["flatten"]


def flatten(shred: Shred, rep: Optional[str] = None,
            policy: KernelPolicy = DEFAULT_POLICY) -> Dict[str, torch.Tensor]:
    """mu*(N): materialize the full join from the index by probing every
    position, in the canonical flatten order."""
    n = int(shred.join_size)
    if n == 0 or shred.root.num_rows == 0:
        return {v: node.data.column(v)[:0]
                for node in shred.root.nodes() for v in node.owned}
    pos = torch.arange(n, dtype=torch.int64, device=shred.device)
    return probe.get(shred, pos, rep=rep, policy=policy)
