"""Causal or full flash attention over whole sequences, with GQA:
``softmax(q . K^T / sqrt(D), keys j <= i when causal) . V`` in float32,
out in q's dtype. q ``(B, H, S, D)``, k/v ``(B, KV, S, D)``; query head h
reads KV head ``h // (H / KV)``.

``flash_prefill`` launches ``csrc/flash_prefill.cu`` for CUDA tensors
(one block per query tile of 64 rows, head and batch row; K and V tiles
stream through shared memory under an online softmax) and runs
``flash_prefill_plain`` for CPU tensors; ``launches`` counts its calls
that launch the kernel. The kernel takes any S: keys past the end are
left out, causal or not, so no padding is needed.

The plain version is the dense oracle. It walks batch rows and KV heads,
so its float32 scores are one group's ``(G, S, S)`` at a time.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["HEAD_DIMS", "flash_prefill_plain", "flash_prefill"]

HEAD_DIMS = (64, 128, 256)  # the kernel's instances (flash_prefill.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MASK = -1e30  # the reference's causal mask value


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or KV == 0 or H % KV:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_prefill: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("flash_prefill: operands on different devices")
    return B, H, KV, S, D


def flash_prefill_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """The dense attention, one (batch row, KV head) group at a time."""
    B, H, KV, S, D = _shapes(q, k, v)
    G = H // KV
    out = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    keep = (torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
            if causal else None)
    for b in range(B):
        for j in range(KV):
            heads = slice(j * G, (j + 1) * G)
            s = torch.matmul(q[b, heads].to(torch.float32),
                             k[b, j].to(torch.float32).T) / D ** 0.5
            if causal:
                s = torch.where(keep, s, _MASK)
            out[b, heads] = torch.matmul(torch.softmax(s, dim=-1),
                                         v[b, j].to(torch.float32))
    return out.to(q.dtype)


def flash_prefill(q, k, v, causal: bool = True) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, S, D). Returns (B, H, S, D) in q's
    dtype."""
    B, H, KV, S, D = _shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_prefill: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS or S < 1:
        raise ValueError(f"flash_prefill: the kernel takes D in {HEAD_DIMS} "
                         f"and S >= 1; got D={D}, S={S}")
    from . import build

    fn = build.library("flash_prefill").flash_prefill_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    q, k, v = (build.vector_operand(t) for t in (q, k, v))
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), B, H, KV, S, D,
                       int(bool(causal)), 1.0 / D ** 0.5, stream),
                    "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
