"""Fused USR-GET over the packed int32 index arena.

``tree_probe`` resolves int32 probe positions to the row of every tree
node in one launch of ``csrc/tree_probe.cu`` for CUDA tensors; for CPU
tensors it runs ``tree_walk``, the plain version, which the fused draw's
plain version shares. ``launches`` counts kernel launches.

The kernel is built once for any layout: the layout travels as a small
int32 table (``layout_table``), at most ``MAX_SLOTS`` tree nodes.

``tree_probe_paged`` is the same walk over a paged arena (``PagedArena``:
the root prefix, then one page per tree edge), from ``csrc/
tree_probe_paged.cu``: one launch per page (``dma`` false, the default),
or one launch over the stacked pages (``dma=True``, counted on
``tree_probe_paged_dma``). Its plain version, ``tree_probe_paged_plain``,
runs the same page steps as torch ops for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from .bsearch_probe import steps_for

__all__ = ["MAX_SLOTS", "layout_table", "tree_walk", "tree_probe_plain",
           "tree_probe", "tree_probe_paged_plain", "tree_probe_paged",
           "tree_probe_paged_dma"]

MAX_SLOTS = 16  # RT_MAX_SLOTS in csrc/tree_walk.cuh


def layout_table(layout) -> List[int]:
    """The kernels' layout table: [root_len, n_root, root_steps,
    num_edges] then per edge [parent, slot, cs_off, cw_off, ce_off,
    perm_off, n_child, steps over cumw_excl]."""
    if layout.num_slots > MAX_SLOTS:
        raise ValueError(f"{layout.num_slots} tree nodes; the kernels take "
                         f"at most {MAX_SLOTS}")
    table = [layout.root_len, layout.n_root, steps_for(layout.root_len),
             len(layout.edges)]
    for e in layout.edges:
        table += [e.parent, e.slot, e.cs_off, e.cw_off, e.ce_off, e.perm_off,
                  e.n_child, steps_for(e.n_child + 1)]
    return table


def _descend(arena: torch.Tensor, off: int, length: int, q: torch.Tensor):
    """max j in [0, length-1] with arena[off + j] <= q (branchless)."""
    p = torch.zeros_like(q)
    for k in range(steps_for(length) - 1, -1, -1):
        cand = p + (1 << k)
        val = arena[off + torch.clamp(cand, max=length - 1)]
        p = torch.where((cand < length) & (val <= q), cand, p)
    return p


def tree_walk(arena: torch.Tensor, pos: torch.Tensor, layout):
    """The pre-order USR walk as torch ops: int32 probe positions -> the
    row of each slot (``layout.names`` order)."""
    j = torch.clamp(_descend(arena, 0, layout.root_len, pos),
                    max=layout.n_root - 1)
    rows = {0: j}
    locs = {0: pos - arena[j]}
    for e in layout.edges:
        prow = rows[e.parent]
        w_safe = torch.clamp(arena[e.cw_off + prow], min=1)
        idx = torch.remainder(locs[e.parent], w_safe)
        locs[e.parent] = torch.div(locs[e.parent], w_safe,
                                   rounding_mode="floor")
        start = arena[e.cs_off + prow]
        target = arena[e.ce_off + start] + idx
        jj = torch.clamp(_descend(arena, e.ce_off, e.n_child + 1, target),
                         max=e.n_child - 1)
        rows[e.slot] = arena[e.perm_off + jj]
        locs[e.slot] = target - arena[e.ce_off + jj]
    return [rows[s] for s in range(len(rows))]


def tree_probe_plain(arena: torch.Tensor, q: torch.Tensor, layout):
    return torch.stack(tree_walk(arena, q, layout))


def tree_probe(arena: torch.Tensor, q: torch.Tensor, layout) -> torch.Tensor:
    """arena: (layout.size,) int32; q: int32 probe positions in
    [0, join size), any shape. Returns (num_slots,) + q.shape int32."""
    if arena.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"tree_probe takes int32, got {arena.dtype}/{q.dtype}")
    if arena.shape != (layout.size,):
        raise ValueError(f"arena {tuple(arena.shape)} vs layout size {layout.size}")
    if arena.device != q.device:
        raise ValueError(f"arena on {arena.device}, q on {q.device}")
    if q.device.type == "cpu":
        return tree_probe_plain(arena, q, layout)
    if q.device.type != "cuda":
        raise ValueError(f"tree_probe: unsupported device {q.device}")
    from . import build

    fn = build.library("tree_probe").tree_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    table = layout_table(layout)
    ctable = (ctypes.c_int * len(table))(*table)
    qc = q.contiguous()
    out = torch.empty((layout.num_slots,) + tuple(q.shape), dtype=torch.int32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(arena.contiguous().data_ptr(), ctable, qc.data_ptr(),
                       out.data_ptr(), qc.numel(), stream), "tree_probe")
    tree_probe.launches += 1
    return out


tree_probe.launches = 0


# ---------------------------------------------------------------------------
# Paged walk: the edges of tree_walk, each against its own page, offsets
# rebased by the page start.
# ---------------------------------------------------------------------------

def _root_page_step(page: torch.Tensor, pos: torch.Tensor, layout):
    """Root locate against page 0 (the root prefix: no rebase)."""
    j = torch.clamp(_descend(page, 0, layout.root_len, pos),
                    max=layout.n_root - 1)
    return j, pos - page[j]


def _edge_page_step(page: torch.Tensor, e, prow, plocal):
    """One edge of ``tree_walk`` against its page: ``(child row, child
    local, the parent's local after the peel)``."""
    base = e.cs_off
    w_safe = torch.clamp(page[(e.cw_off - base) + prow], min=1)
    idx = torch.remainder(plocal, w_safe)
    pnew = torch.div(plocal, w_safe, rounding_mode="floor")
    ce = e.ce_off - base
    target = page[ce + page[prow]] + idx
    jj = torch.clamp(_descend(page, ce, e.n_child + 1, target),
                     max=e.n_child - 1)
    return page[(e.perm_off - base) + jj], target - page[ce + jj], pnew


def tree_probe_paged_plain(paged, q: torch.Tensor, dma: bool = False):
    """The paged walk as torch ops, over ``paged.pages`` one by one, or
    (``dma``) over the rows of ``paged.stacked()``; both equal
    ``tree_probe_plain`` on the whole arena."""
    layout = paged.layout
    pages = list(paged.stacked()[0]) if dma else paged.pages
    j, local = _root_page_step(pages[0], q, layout)
    rows, locs = {0: j}, {0: local}
    for k, e in enumerate(layout.edges):
        rows[e.slot], locs[e.slot], locs[e.parent] = _edge_page_step(
            pages[k + 1], e, rows[e.parent], locs[e.parent])
    return torch.stack([rows[s] for s in range(layout.num_slots)])


def _check_paged(paged, q: torch.Tensor) -> None:
    if q.dtype != torch.int32 or paged.buffer.dtype != torch.int32:
        raise TypeError(f"tree_probe_paged takes int32, got "
                        f"{paged.buffer.dtype}/{q.dtype}")
    if paged.buffer.shape != (paged.layout.size,):
        raise ValueError(f"arena {tuple(paged.buffer.shape)} vs layout size "
                         f"{paged.layout.size}")
    if paged.buffer.device != q.device:
        raise ValueError(f"pages on {paged.buffer.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tree_probe_paged: unsupported device {q.device}")


def tree_probe_paged(paged, q: torch.Tensor, dma=None) -> torch.Tensor:
    """paged: a ``PagedArena``; q: int32 probe positions in [0, join
    size), any shape. Returns (num_slots,) + q.shape int32, equal to
    ``tree_probe`` on the whole arena. ``dma=None`` is the per-page form
    (one launch per page, ``launches`` counts each); ``dma=True`` the
    one-launch form over the stacked pages."""
    _check_paged(paged, q)
    if q.device.type == "cpu":
        return tree_probe_paged_plain(paged, q, dma=bool(dma))
    if dma:
        return tree_probe_paged_dma(paged, q)
    from . import build

    lib = build.library("tree_probe_paged")
    root, edge = lib.tpp_root_launch, lib.tpp_edge_launch
    root.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                ctypes.c_void_p])
    edge.argtypes = ([ctypes.c_void_p] * 5
                     + [ctypes.c_longlong, ctypes.c_void_p])
    root.restype = edge.restype = ctypes.c_int
    layout = paged.layout
    qc = q.contiguous()
    n = qc.numel()
    pages = paged.pages  # views of one contiguous buffer: no copies
    table = layout_table(layout)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        jl = torch.empty((2,) + tuple(q.shape), dtype=torch.int32,
                         device=q.device)
        build.check(root(pages[0].data_ptr(), layout.root_len, layout.n_root,
                         table[2], qc.data_ptr(), jl.data_ptr(), n, stream),
                    "tree_probe_paged")
        tree_probe_paged.launches += 1
        rows, locs = {0: jl[0]}, {0: jl[1]}
        for k, e in enumerate(layout.edges):
            fields = table[4 + 8 * k: 12 + 8 * k]
            out = torch.empty((3,) + tuple(q.shape), dtype=torch.int32,
                              device=q.device)
            build.check(edge(pages[k + 1].data_ptr(),
                             (ctypes.c_int * 8)(*fields),
                             rows[e.parent].data_ptr(),
                             locs[e.parent].data_ptr(), out.data_ptr(), n,
                             stream), "tree_probe_paged")
            tree_probe_paged.launches += 1
            rows[e.slot], locs[e.slot], locs[e.parent] = out[0], out[1], out[2]
    return torch.stack([rows[s] for s in range(layout.num_slots)])


tree_probe_paged.launches = 0


def tree_probe_paged_dma(paged, q: torch.Tensor) -> torch.Tensor:
    """The one-launch paged walk over ``paged.stacked()`` (built once per
    ``PagedArena``), on the card; ``tree_probe_paged(..., dma=True)``."""
    _check_paged(paged, q)
    if q.device.type == "cpu":
        return tree_probe_paged_plain(paged, q, dma=True)
    from . import build

    fn = build.library("tree_probe_paged").tpp_stacked_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    layout = paged.layout
    stacked, P = paged.stacked()
    table = layout_table(layout)
    qc = q.contiguous()
    out = torch.empty((layout.num_slots,) + tuple(q.shape), dtype=torch.int32,
                      device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(stacked.data_ptr(), P,
                       (ctypes.c_int * len(table))(*table), qc.data_ptr(),
                       out.data_ptr(), qc.numel(), stream),
                    "tree_probe_paged_dma")
    tree_probe_paged_dma.launches += 1
    return out


tree_probe_paged_dma.launches = 0
