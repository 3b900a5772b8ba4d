"""Inclusive prefix sum in flat row-major order (weights -> pref vector).

``prefix_sum_tiles`` launches ``csrc/scan.cu`` for CUDA tensors and runs
``prefix_sum_plain`` for CPU tensors; ``launches`` counts its calls that
launch the kernel. The reference's kernel carries its total through a
sequential grid. On the card every type is one kernel that reads the
input once, its tiles taken by ticket, its status words in a scratch
kept per device and stream and tagged by the launch's epoch, so a call
needs no reset and no allocation beyond its output. int32 takes a
decoupled look-back; float32 and float64 keep a fixed order, the order of
a reduce-then-scan (tile totals, the totals scanned in chunks of one
tile, the tiles with their carries): the tiles publish their totals, the
last tile of each group of ``ITEMS`` publishes the group's sum, and each
tile computes its carry from those before it. Both are described in the
source.

The kernel masks its own ragged edge, so it takes any shape (the
reference's ``(R, 128)`` tiles or a flat vector) with no padding.

int32 sums wrap as XLA's int32 cumsum wraps (the kernel adds in uint32;
the plain version sums in int64 and wraps to 32 bits, which any order
gives alike). The floats are order-sensitive: ``scan_order`` spells out
the kernel's order for any tile shape and either float type, so the two
agree bit for bit on the card; the fused draw's arrival sum
(``fused_draw.arrivals``) runs the same order at its own tile shape. The
float64 instance sums the engine's mass prefixes (``core/sampling.py``): a
library scan there (``torch.cumsum`` on the card) sums in an order that
changes from run to run, so one key could draw two samples.
"""
from __future__ import annotations

import ctypes
import types
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import build

__all__ = ["THREADS", "ITEMS", "TILE", "LOOK_BACK_TILE",
           "LOOK_BACK_SMALL_TILE", "prefix_sum_plain", "prefix_sum_tiles",
           "scan_order", "wrap_i32", "scan_launch", "look_back_tile"]

THREADS = 256           # SC_THREADS in csrc/scan.cu: the floats' order
ITEMS = 16              # SC_ITEMS
TILE = THREADS * ITEMS  # SC_TILE: elements per block of the float passes
LOOK_BACK_TILE = 8192   # LB_TILE: elements per block of the int32 scan
LOOK_BACK_SMALL_TILE = 2048  # LB_SMALL_TILE: its tile below one wave


def wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 with two's-complement wrap (uint32 adds)."""
    return ((s + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _tiles(x: torch.Tensor, threads: int, items: int):
    """One block's order over each tile of ``x`` (1-D float32 or float64) of
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


def scan_order(x: torch.Tensor, threads: int, items: int) -> torch.Tensor:
    """Inclusive sum of the 1-D float32 or float64 ``x``, in its type, in
    ``csrc/scan.cuh``'s order at tiles of ``threads * items``: each tile scanned by ``_tiles``; the
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
    """The kernel's sums as torch ops: int32 wraps, the floats in their
    order."""
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return x.clone()
    if x.dtype == torch.int32:
        return wrap_i32(torch.cumsum(flat.to(torch.int64), 0)).reshape(x.shape)
    return scan_order(flat, THREADS, ITEMS).reshape(x.shape)


_VP, _LL = ctypes.c_void_p, ctypes.c_longlong
_FLOAT_ENTRIES = {torch.float32: "scan_f32", torch.float64: "scan_f64"}
# csrc/scan.cu's <entry>_launch: (input, [scalars], output, n, scratch...,
# stream); the look-back's scratch is (words, capacity, host state).
_ARGTYPES = {"scan_i32": [_VP, _VP, _LL, _VP, _LL, _VP, _VP],
             "geo_gaps": [_VP, ctypes.c_float, _VP, _LL, _VP, _LL, _VP, _VP],
             "scan_f32": [_VP, _VP, _LL, _VP, _LL, _VP, _VP],
             "scan_f64": [_VP, _VP, _LL, _VP, _LL, _VP, _VP]}
# status words a tile of the float scans: 32 bits of the total a word
_FLOAT_WORDS = {"scan_f32": 1, "scan_f64": 2}


class _LookBack:
    """The look-back's scratch on one (device, stream): ``words`` (the
    ticket, then the tiles' status words; zero when made) and the host
    state ``[epoch of the last launch, ticket base]`` that each launch of
    any entry advances (``csrc/scan.cu`` ``lb_run``)."""

    def __init__(self, device: torch.device, capacity: int):
        self.words = torch.zeros(capacity, dtype=torch.int64, device=device)
        self.capacity = capacity
        self.state = (ctypes.c_uint * 2)()


_SCRATCH: Dict[Tuple[int, int], _LookBack] = {}


def _words_needed(entry: str, n: int) -> int:
    """The scratch words a launch of ``entry`` over ``n`` elements may
    use, the ticket's included: a word a tile of the look-back (the small
    tile's count bounds either tile's); for the floats ``_FLOAT_WORDS``
    for each tile of ``TILE`` (its total) and each group of ``ITEMS``
    tiles (its sum)."""
    if entry in _FLOAT_WORDS:
        nt = -(-n // TILE)
        return _FLOAT_WORDS[entry] * (nt + -(-nt // ITEMS)) + 1
    return -(-n // LOOK_BACK_SMALL_TILE) + 1


def _look_back_scratch(device: torch.device, stream: int,
                       need: int) -> _LookBack:
    """The scratch of ``stream`` on ``device``, grown (to a power of two
    words, zeroed) when a launch needs more than ``need`` words."""
    s = _SCRATCH.get((device.index, stream))
    if s is None or s.capacity < need:
        s = _SCRATCH[(device.index, stream)] = _LookBack(
            device, 1 << (need - 1).bit_length())
    return s


def scan_launch(entry: str, x: torch.Tensor, out: torch.Tensor,
                *scalars) -> None:
    """Launch one entry of ``csrc/scan.cu`` over the flat ``x`` into
    ``out``, every entry on the cached scratch of the current stream (no
    allocation and no reset in steady state). ``scalars`` go between ``x``
    and ``out`` (GEO's clipped p)."""
    fn = build.entry("scan", f"{entry}_launch", _ARGTYPES[entry])
    n = x.numel()
    dev = x.device
    with build.on_device(dev):
        stream = build.current_stream(dev)
        s = _look_back_scratch(dev, stream, _words_needed(entry, n))
        err = fn(x.data_ptr(), *scalars, out.data_ptr(), n,
                 s.words.data_ptr(), s.capacity, s.state, stream)
        if err:
            # a refused launch leaves the scratch's state unknown: the next
            # call starts from a fresh one
            del _SCRATCH[(dev.index, stream)]
        build.check(err, entry)


def look_back_tile(n: int, device=None) -> int:
    """The tile (elements a block) that the int32 and GEO look-back takes
    for ``n`` elements on the card (the current one unless ``device``):
    ``LOOK_BACK_SMALL_TILE`` below one wave of ``LOOK_BACK_TILE``."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    fn = build.entry("scan", "scan_look_back_tile",
                     [_LL, ctypes.POINTER(ctypes.c_int)])
    tile = ctypes.c_int()
    with build.on_device(device):
        build.check(fn(n, ctypes.byref(tile)), "scan_look_back_tile")
    return tile.value


def prefix_sum_tiles(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of an int32, float32 or float64 tensor in flat
    row-major order, in ``x``'s shape (the reference takes ``(R, 128)``
    tiles of any type; any shape is taken here)."""
    if x.dtype != torch.int32 and x.dtype not in _FLOAT_ENTRIES:
        raise TypeError("prefix_sum_tiles takes int32, float32 or float64, "
                        f"got {x.dtype}")
    if x.device.type == "cpu":
        return prefix_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"prefix_sum_tiles: unsupported device {x.device}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    scan_launch(_FLOAT_ENTRIES.get(x.dtype, "scan_i32"), xc, out)
    _COUNTERS.get(x.dtype, prefix_sum_tiles).launches += 1
    return out


# launches of the int32 instance; float32.launches and float64.launches:
# the float instances' (the float64 one is the engine's mass prefix), each
# a kernel of its own
prefix_sum_tiles.launches = 0
prefix_sum_tiles.float32 = types.SimpleNamespace(launches=0)
prefix_sum_tiles.float64 = types.SimpleNamespace(launches=0)
_COUNTERS = {torch.float32: prefix_sum_tiles.float32,
             torch.float64: prefix_sum_tiles.float64}
