"""Bulk binary search of int32 probes into a sorted int32 prefix vector:
for each query q, the largest j with ``pref[j] <= q`` (``pref[0] == 0``).

The inner loop of USR-GET's root location and of EXPRACE's prefix
searches. ``bsearch_probe`` launches ``csrc/bsearch_probe.cu`` for CUDA
tensors and runs ``bsearch_probe_plain`` for CPU tensors; ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["steps_for", "bsearch_probe_plain", "bsearch_probe"]


def steps_for(length: int) -> int:
    """Descent steps over a vector of ``length``: max(1, ceil(log2 L))."""
    return max(1, (max(length, 2) - 1).bit_length())


def bsearch_probe_plain(pref: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernel's branchless power-of-two descent as torch ops."""
    np_len = pref.shape[0]
    pos = torch.zeros_like(q, dtype=torch.int32)
    for k in range(steps_for(np_len) - 1, -1, -1):
        cand = pos + (1 << k)
        val = pref[torch.clamp(cand, max=np_len - 1)]
        take = (cand < np_len) & (val <= q)
        pos = torch.where(take, cand, pos)
    return pos


def _check(pref: torch.Tensor, q: torch.Tensor) -> None:
    if pref.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"bsearch_probe takes int32, got {pref.dtype}/{q.dtype}")
    if pref.ndim != 1 or pref.shape[0] == 0:
        raise ValueError(f"pref must be a non-empty vector, got {tuple(pref.shape)}")
    if pref.device != q.device:
        raise ValueError(f"pref on {pref.device}, q on {q.device}")


def bsearch_probe(pref: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """pref: (NP,) int32 ascending with pref[0] == 0; q: int32, any shape.
    Returns int32 of q's shape: max j with pref[j] <= q."""
    _check(pref, q)
    if q.device.type == "cpu":
        return bsearch_probe_plain(pref, q)
    if q.device.type != "cuda":
        raise ValueError(f"bsearch_probe: unsupported device {q.device}")
    from . import build

    fn = build.library("bsearch_probe").bsearch_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pref = pref.contiguous()
    qc = q.contiguous()
    out = torch.empty_like(qc)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(pref.data_ptr(), pref.shape[0],
                       steps_for(pref.shape[0]), qc.data_ptr(),
                       out.data_ptr(), qc.numel(), stream), "bsearch_probe")
    bsearch_probe.launches += 1
    return out


bsearch_probe.launches = 0
