"""Layout plumbing and policy dispatch around the kernels.

``searchsorted_prefix`` routes int32 searches through the bsearch kernel
(the table lives in device memory, so there is no size budget) and every
other dtype, or a disabled policy, through ``torch.searchsorted``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import DEFAULT_POLICY, KernelPolicy

from .bsearch_probe import bsearch_probe

__all__ = ["to_tiles", "searchsorted_prefix"]


def to_tiles(x: torch.Tensor, fill=0) -> torch.Tensor:
    """Pad a 1-D vector to a whole number of 128-lane rows and retile —
    the reference kernels' (R, 128) query layout."""
    n = x.shape[0]
    rows = -(-n // 128)
    return F.pad(x, (0, rows * 128 - n), value=fill).reshape(rows, 128)


def searchsorted_prefix(pref: torch.Tensor, q: torch.Tensor,
                        policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """max j with pref[j] <= q (== ``searchsorted(pref, q, right) - 1``
    clamped at 0). The bsearch kernel for int32 tables and queries; the
    library search for every other dtype (int64 joins, float masses)."""
    if (pref.dtype != torch.int32 or q.dtype != torch.int32
            or not policy.enabled):
        return torch.clamp(torch.searchsorted(pref, q, right=True) - 1, min=0)
    return bsearch_probe(pref, q)
