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
  * float32: ``csrc/flash_prefill.cu``, on the CUDA cores. The reference
    computes in float32, and the tensor cores' TF32 keeps too few digits
    for its tolerances. A persistent grid (one block of four warps an SM)
    takes work items of ``TILE_Q`` query rows, head and batch row from a
    ticket counter in ``work_order``, heaviest first; K and V stream
    through a ``cp.async`` ring; each warp keeps its scores and its online
    softmax in registers (base 2). The counter lives in a scratch per
    (device, stream), which the kernel leaves at 0.

Both run an online softmax over key tiles, so no S x S score matrix
exists, and take any S: keys past the end are left out, causal or not, so
no padding is needed.

The plain version is the dense oracle. It walks batch rows and KV heads,
so its float32 scores are one group's ``(G, S, S)`` at a time.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from . import build

__all__ = ["HEAD_DIMS", "TILE_Q", "F32_SHAPES", "work_order",
           "flash_prefill_plain", "flash_prefill"]

HEAD_DIMS = (64, 128, 256)  # the kernels' instances
TILE_Q = 64  # query rows of a float32 work item (FP_BQ)
# the float32 kernel's FpShape<D>: (row warps, key warps, keys a tile); a
# warp takes TILE_Q / row warps rows and keys a tile / key warps keys
F32_SHAPES = {64: (2, 2, 128), 128: (4, 1, 64), 256: (4, 1, 32)}
_MASK = -1e30  # the reference's causal mask value
_VP, _INT = ctypes.c_void_p, ctypes.c_int
# library, entry and C prototype of each dtype's kernel: (q, k, v, out,
# [ticket], B, H, KV, S, D, causal, scale, stream)
_ENTRIES = {
    torch.bfloat16: ("flash_prefill_tc", "flash_prefill_tc_launch",
                     [_VP] * 4 + [_INT] * 6 + [ctypes.c_float, _VP]),
    torch.float32: ("flash_prefill", "flash_prefill_launch",
                    [_VP] * 5 + [_INT] * 6 + [ctypes.c_float, _VP])}


def work_order(S: int, H: int, B: int) -> List[Tuple[int, int, int]]:
    """The float32 kernel's work items (query tile, head, batch row) in the
    order its blocks take them from the ticket: the last query tile first
    (under causal attention it walks the most keys; under full attention
    every tile walks all S), and within a tile batch row by batch row,
    head by head."""
    T = -(-S // TILE_Q)
    return [(T - 1 - n // (H * B), n % (H * B) % H, n % (H * B) // H)
            for n in range(T * H * B)]


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


# the float32 kernel's ticket per (device index, stream): [next item,
# blocks done], 0 between launches
_TICKETS: Dict[Tuple[object, int], torch.Tensor] = {}


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    """Launch q.dtype's kernel on q's stream, or raise."""
    B, H, S, D = q.shape
    name, entry, argtypes = _ENTRIES[q.dtype]
    fn = build.entry(name, entry, argtypes)
    q, k, v = (build.vector_operand(t) for t in (q, k, v))
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    dev = q.device
    with build.on_device(dev):
        stream = build.current_stream(dev)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if q.dtype == torch.float32:
            ticket = _TICKETS.get((dev.index, stream))
            if ticket is None:
                ticket = _TICKETS[(dev.index, stream)] = torch.zeros(
                    2, dtype=torch.int32, device=dev)
            args.append(ticket.data_ptr())
        err = fn(*args, B, H, k.shape[1], S, D, int(bool(causal)),
                 1.0 / D ** 0.5, stream)
        if err and q.dtype == torch.float32:
            # a refused launch may leave the ticket mid-count
            del _TICKETS[(dev.index, stream)]
        build.check(err, entry)
    return out
