"""Inclusive prefix sum in flat row-major order (weights -> pref vector).

``prefix_sum_tiles`` launches ``csrc/scan.cu`` for CUDA tensors and runs
``prefix_sum_plain`` for CPU tensors; ``launches`` counts its calls that
launch the kernel. The reference's kernel carries its total through a
sequential grid; the CUDA kernel is a reduce-then-scan in three launches
(tile totals, one block scanning them into carries, the tiles scanned
again with their carries), described in the source.

The kernel masks its own ragged edge, so it takes any shape (the
reference's ``(R, 128)`` tiles or a flat vector) with no padding.

int32 sums wrap as XLA's int32 cumsum wraps (the kernel adds in uint32;
the plain version sums in int64 and wraps to 32 bits, which any order
gives alike). float32 is order-sensitive: ``_scan_f32`` spells out the
kernel's order, so the two agree bit for bit on the card.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["THREADS", "ITEMS", "TILE", "prefix_sum_plain",
           "prefix_sum_tiles", "wrap_i32", "scan_launch"]

THREADS = 256           # SC_THREADS in csrc/scan.cu
ITEMS = 16              # SC_ITEMS
TILE = THREADS * ITEMS  # SC_TILE: elements per block


def wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap (uint32 adds)."""
    return ((s + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _tiles(x: torch.Tensor):
    """One block's order over each tile of ``x`` (1-D float32): the
    tile-local inclusive prefixes ``(ntiles, TILE)`` and the tile totals."""
    nt = max(1, -(-x.shape[0] // TILE))
    xs = F.pad(x, (0, nt * TILE - x.shape[0])).reshape(nt, THREADS, ITEMS)
    loc = [xs[:, :, 0]]
    for i in range(1, ITEMS):
        loc.append(loc[-1] + xs[:, :, i])
    loc = torch.stack(loc, dim=2)
    incl = loc[:, :, ITEMS - 1]
    d = 1
    while d < THREADS:
        incl = torch.cat([incl[:, :d], incl[:, d:] + incl[:, :-d]], dim=1)
        d *= 2
    pre = torch.cat([loc[:, :1], incl[:, :-1, None] + loc[:, 1:]], dim=1)
    return pre.reshape(nt, TILE), incl[:, THREADS - 1]


def _scan_f32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's three passes on a 1-D float32 vector, in its order."""
    n = x.shape[0]
    pre, tot = _tiles(x)
    pre2, tot2 = _tiles(tot)
    carry = torch.zeros((), dtype=x.dtype, device=x.device)
    incl = []
    for c in range(pre2.shape[0]):
        incl.append(carry + pre2[c])
        carry = carry + tot2[c]
    carries = torch.cat([carry.new_zeros(1), torch.cat(incl)[:tot.shape[0] - 1]])
    return (carries[:, None] + pre).reshape(-1)[:n]


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's sums as torch ops: int32 wraps, float32 in its order."""
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return x.clone()
    if x.dtype == torch.int32:
        return wrap_i32(torch.cumsum(flat.to(torch.int64), 0)).reshape(x.shape)
    return _scan_f32(flat).reshape(x.shape)


def scan_launch(entry: str, x: torch.Tensor, out: torch.Tensor,
                *scalars) -> None:
    """Launch one entry of ``csrc/scan.cu`` over the flat ``x`` into
    ``out``, with the tile-total and carry scratch it needs. ``scalars``
    go between ``x`` and ``out`` (GEO's clipped p)."""
    from . import build

    fn = getattr(build.library("scan"), f"{entry}_launch")
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_float] * len(scalars)
                   + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    n = x.numel()
    nt = max(1, -(-n // TILE))
    scratch = torch.empty((2, nt), dtype=out.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(fn(x.data_ptr(), *scalars, out.data_ptr(), n,
                       scratch[0].data_ptr(), scratch[1].data_ptr(), stream),
                    entry)


def prefix_sum_tiles(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an int32 or float32 tensor in flat
    row-major order, in ``x``'s shape (the reference takes ``(R, 128)``
    tiles; any shape is taken here)."""
    if x.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"prefix_sum_tiles takes int32 or float32, got {x.dtype}")
    if x.device.type == "cpu":
        return prefix_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sum_tiles: unsupported device {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    scan_launch("scan_i32" if x.dtype == torch.int32 else "scan_f32", xc, out)
    prefix_sum_tiles.launches += 1
    return out


prefix_sum_tiles.launches = 0
