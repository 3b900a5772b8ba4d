"""Fused USR-GET over the packed int32 index arena.

``tree_probe`` resolves int32 probe positions to the row of every tree
node in one launch of ``csrc/tree_probe.cu`` for CUDA tensors; for CPU
tensors it runs ``tree_walk``, the plain version, which the fused draw's
plain version shares. ``launches`` counts kernel launches.

The kernel is built once for any layout: the layout travels as a small
int32 table (``layout_table``), at most ``MAX_SLOTS`` tree nodes.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

from .bsearch_probe import steps_for

__all__ = ["MAX_SLOTS", "layout_table", "tree_walk", "tree_probe_plain",
           "tree_probe"]

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
