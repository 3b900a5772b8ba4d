"""One-token decode attention over a KV cache, with GQA and an additive
bias: ``softmax(q . K^T / sqrt(D) + bias) . V`` in float32, out in q's
dtype. q ``(B, H, D)``, k/v ``(B, KV_H, S, D)``, bias ``(B, S)`` float32;
query head h reads KV head ``h // (H / KV_H)``.

``flash_decode`` launches ``csrc/flash_decode.cu`` for CUDA tensors (one
block per S-split, KV head and batch row, then a combine of the splits)
and runs ``flash_decode_plain`` for CPU tensors; ``launches`` counts its
calls that launch the kernel. The kernel takes any S: keys past the end
of the cache are left out, so no padding is needed.

The plain version is the dense oracle. It groups q as ``(B, KV_H, G, D)``
and walks the KV heads, so its float32 temporaries stay one head of the
cache at a time (no ``repeat_interleave`` of the cache).
"""
from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["SPLIT", "HEAD_DIMS", "MAX_GROUP_WIDTH", "flash_decode_plain",
           "flash_decode"]

SPLIT = 1024              # FD_SPLIT in csrc/flash_decode.cu: keys per block
HEAD_DIMS = (64, 128, 256)  # the kernel's instances
MAX_GROUP_WIDTH = 4096    # 4 * FD_THREADS * FD_SLOTS: the most G * D a block holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(q, k, v, bias):
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, D = q.shape
    _, KVH, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}")
    if tuple(bias.shape) != (B, S) or bias.dtype != torch.float32:
        raise ValueError(f"flash_decode: bias must be ({B}, {S}) float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_decode: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if len({t.device for t in (q, k, v, bias)}) != 1:
        raise ValueError("flash_decode: operands on different devices")
    return B, H, KVH, S, D


def flash_decode_plain(q, k, v, bias) -> torch.Tensor:
    """The dense decode attention, one KV head at a time."""
    B, H, KVH, S, D = _shapes(q, k, v, bias)
    G = H // KVH
    qf = q.to(torch.float32).reshape(B, KVH, G, D)
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    for j in range(KVH):
        logits = (torch.matmul(qf[:, j], k[:, j].to(torch.float32).transpose(1, 2))
                  / D ** 0.5 + bias[:, None, :])
        w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        w = w / w.sum(dim=-1, keepdim=True)
        out[:, j] = torch.matmul(w, v[:, j].to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)


def flash_decode(q, k, v, bias) -> torch.Tensor:
    """q (B, H, D), k/v (B, KV_H, S, D), bias (B, S) float32 additive
    (0 or -1e30: padding and window masks). Returns (B, H, D) in q's
    dtype."""
    B, H, KVH, S, D = _shapes(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode: the kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if D not in HEAD_DIMS or (H // KVH) * D > MAX_GROUP_WIDTH or S < 1:
        raise ValueError(f"flash_decode: the kernel takes D in {HEAD_DIMS}, "
                         f"G * D <= {MAX_GROUP_WIDTH} and S >= 1; got D={D}, "
                         f"G={H // KVH}, S={S}")
    from . import build

    fn = build.library("flash_decode").flash_decode_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    q, k, v, bias = (build.vector_operand(t) for t in (q, k, v, bias))
    nsplit = math.ceil(S / SPLIT)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    ml = B * H * nsplit
    part = torch.empty((ml * (D + 2),), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                       part.data_ptr(), part[ml * D:].data_ptr(),
                       part[ml * (D + 1):].data_ptr(), B, H, KVH, S, D,
                       1.0 / D ** 0.5, stream), "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
