"""Causal or full flash attention over whole sequences, with GQA:
``softmax(q . K^T / sqrt(D), keys j <= i when causal) . V`` in float32,
out in q's dtype. q ``(B, H, S, D)``, k/v ``(B, KV, S, D)``; query head h
reads KV head ``h // (H / KV)``.

``flash_prefill`` launches a kernel for CUDA tensors and runs
``flash_prefill_plain`` for CPU tensors; ``launches`` counts its calls that
launch a kernel. Each dtype has its own kernel, and neither stands in for
the other:

  * bf16: ``csrc/flash_prefill_tc.cu``, on the tensor cores (``wgmma``):
    one block of a TMA producer and two consumer warpgroups per 128 query
    rows, head and batch row; K and V stream through a two-stage ring;
  * float32: ``csrc/flash_prefill.cu``, on the CUDA cores: one block per 64
    query rows, head and batch row. The reference computes in float32, and
    the tensor cores' TF32 keeps too few digits for its tolerances.

Both run an online softmax over key tiles, so no S x S score matrix
exists, and take any S: keys past the end are left out, causal or not, so
no padding is needed.

The plain version is the dense oracle. It walks batch rows and KV heads,
so its float32 scores are one group's ``(G, S, S)`` at a time.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["HEAD_DIMS", "flash_prefill_plain", "flash_prefill"]

HEAD_DIMS = (64, 128, 256)  # the kernels' instances
# library and entry of each dtype's kernel
_ENTRIES = {torch.bfloat16: ("flash_prefill_tc", "flash_prefill_tc_launch"),
            torch.float32: ("flash_prefill", "flash_prefill_launch")}
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
    if q.dtype not in _ENTRIES:
        raise TypeError(f"flash_prefill: the kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS or S < 1:
        raise ValueError(f"flash_prefill: the kernels take D in {HEAD_DIMS} "
                         f"and S >= 1; got D={D}, S={S}")
    out = _launch(q, k, v, causal)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """Launch q.dtype's kernel on q's stream, or raise."""
    from . import build

    B, H, S, D = q.shape
    name, entry = _ENTRIES[q.dtype]
    fn = getattr(build.library(name), entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    q, k, v = (build.vector_operand(t) for t in (q, k, v))
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, H, k.shape[1], S, D,
                       int(bool(causal)), 1.0 / D ** 0.5, stream), entry)
    return out
