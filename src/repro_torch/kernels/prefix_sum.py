"""Inclusive prefix sum in flat row-major order (weights -> pref vector).

``prefix_sum_tiles`` launches ``csrc/scan.cu`` for CUDA tensors and runs
``prefix_sum_plain`` for CPU tensors; ``launches`` counts its calls that
launch the kernel. The reference's kernel carries its total through a
sequential grid. On the card, int32 takes a single-pass decoupled
look-back scan (one memset of the tiles' status words, one kernel that
reads the input once); float32 takes a reduce-then-scan in three launches
(tile totals, one block scanning them into carries, the tiles scanned
again with their carries), so that its order is fixed. Both are described
in the source.

The kernel masks its own ragged edge, so it takes any shape (the
reference's ``(R, 128)`` tiles or a flat vector) with no padding.

int32 sums wrap as XLA's int32 cumsum wraps (the kernel adds in uint32;
the plain version sums in int64 and wraps to 32 bits, which any order
gives alike). float32 is order-sensitive: ``scan_order_f32`` spells out
the kernel's order for any tile shape, so the two agree bit for bit on the
card; the fused draw's arrival sum (``fused_draw.arrivals``) runs the same
order at its own tile shape.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["THREADS", "ITEMS", "TILE", "LOOK_BACK_TILE", "prefix_sum_plain",
           "prefix_sum_tiles", "scan_order_f32", "wrap_i32", "scan_launch"]

THREADS = 256           # SC_THREADS in csrc/scan.cu: the float32 order
ITEMS = 16              # SC_ITEMS
TILE = THREADS * ITEMS  # SC_TILE: elements per block of the float32 passes
LOOK_BACK_TILE = 8192   # LB_TILE: elements per block of the int32 scan


def wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap (uint32 adds)."""
    return ((s + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _tiles(x: torch.Tensor, threads: int, items: int):
    """One block's order over each tile of ``x`` (1-D float32) of
    ``threads * items`` elements: the tile-local inclusive prefixes
    ``(ntiles, tile)`` and the tile totals."""
    tile = threads * items
    nt = max(1, -(-x.shape[0] // tile))
    xs = F.pad(x, (0, nt * tile - x.shape[0])).reshape(nt, threads, items)
    loc = [xs[:, :, 0]]
    for i in range(1, items):
        loc.append(loc[-1] + xs[:, :, i])
    loc = torch.stack(loc, dim=2)
    incl = loc[:, :, items - 1]
    d = 1
    while d < threads:
        incl = torch.cat([incl[:, :d], incl[:, d:] + incl[:, :-d]], dim=1)
        d *= 2
    pre = torch.cat([loc[:, :1], incl[:, :-1, None] + loc[:, 1:]], dim=1)
    return pre.reshape(nt, tile), incl[:, threads - 1]


def scan_order_f32(x: torch.Tensor, threads: int, items: int) -> torch.Tensor:
    """Inclusive float32 sum of the 1-D ``x`` in ``csrc/scan.cuh``'s order
    at tiles of ``threads * items``: each tile scanned by ``_tiles``; the
    tile totals scanned the same way in chunks of one tile, the carry
    chained from chunk to chunk; an element is its tile's carry + its
    tile-local prefix."""
    n = x.shape[0]
    pre, tot = _tiles(x, threads, items)
    pre2, tot2 = _tiles(tot, threads, items)
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
    return scan_order_f32(flat, THREADS, ITEMS).reshape(x.shape)


_ENTRIES = {}


def _entry(name: str):
    """``csrc/scan.cu``'s ``<name>_launch`` with its argument types, set
    once: (input, [scalars], output, n, scratch..., stream)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from . import build

        fn = getattr(build.library("scan"), f"{name}_launch")
        vp = ctypes.c_void_p
        scalars = [ctypes.c_float] if name == "geo_gaps" else []
        scratch = [vp, vp] if name == "scan_f32" else [vp]
        fn.argtypes = ([vp] + scalars + [vp, ctypes.c_longlong] + scratch
                       + [vp])
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def scan_launch(entry: str, x: torch.Tensor, out: torch.Tensor,
                *scalars) -> None:
    """Launch one entry of ``csrc/scan.cu`` over the flat ``x`` into
    ``out``, with the scratch it needs: the look-back's status words (and
    ticket) for ``scan_i32`` and ``geo_gaps``, the tile totals and carries
    for ``scan_f32``. ``scalars`` go between ``x`` and ``out`` (GEO's
    clipped p)."""
    from . import build

    fn = _entry(entry)
    n = x.numel()
    if entry == "scan_f32":
        nt = max(1, -(-n // TILE))
        scratch = torch.empty((2, nt), dtype=torch.float32, device=x.device)
        ptrs = [scratch[0].data_ptr(), scratch[1].data_ptr()]
    else:
        words = -(-n // LOOK_BACK_TILE) + 1
        scratch = torch.empty((words,), dtype=torch.int64, device=x.device)
        ptrs = [scratch.data_ptr()]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.check(fn(x.data_ptr(), *scalars, out.data_ptr(), n, *ptrs,
                       stream), entry)


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
