"""Fused USR-GET over the packed int32 index arena.

``tree_probe`` resolves int32 probe positions to the row of every tree
node in one launch of ``csrc/tree_get.cu`` for CUDA tensors; for CPU
tensors it runs ``tree_walk``, the plain version, which the fused draw's
plain version shares. ``launches`` counts kernel launches.

The kernel walks the tree by tiles of probes (the design is in
``csrc/tree_get.cuh``): per searched vector the tile's bracket, staged in
shared memory when it is at most ``SPAN`` wide, else a per-lane descent
whose first ``LEVELS`` steps read a pivot table. ``tree_walk_tiled``
spells that logic out as torch ops, so that the CPU tests reach it. The
kernel is built once for any layout: the layout travels as a small int32
table (``layout_table``), at most ``MAX_SLOTS`` tree nodes, with a base per
searched vector, so that the same kernel walks the whole arena, a paged
arena's buffer and its stacked pages.

The tile is ``block_rows`` rows of 128 probes (``autotune``'s parameter:
2, 4, 8 or 16; 256 threads x ``block_rows / 2`` probes a thread); ``None``
is the builtin 8, 1,024 probes. A tree of more than four nodes keeps fewer
probes a thread in registers (``max_items``: 2 up to eight nodes, 1 up to
sixteen) and takes its largest instance at or below the value
(``items_for``). ``core/probe.py`` resolves the tile through
``autotune.tile_for``; a value that names no instance raises.

``tree_probe_paged`` is the same GET over a paged arena (``PagedArena``:
the root prefix, then one page per tree edge). On CUDA its default
(``dma=None``) is one launch of ``tree_get.cu`` over the pages' buffer,
with the layout's own offsets; ``dma=True`` is one launch over the stacked
pages (``tree_probe_paged_dma``); ``dma=False`` the per-page form of
``csrc/tree_probe_paged.cu``, one launch per page
(``tree_probe_paged_pages``). ``tree_probe_paged.launches`` counts every
launch of the paged GET, whatever its form. Its plain versions run the
same steps as torch ops for CPU tensors.

``out_of_bounds`` and ``paged_out_of_bounds`` launch the checked builds of
``tree_get.cu`` and of ``tree_probe_paged.cu`` (``build.VARIANTS``): a
measurement, counted in no ``launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence

import torch

from . import build
from .autotune import check_value, count_tile
from .bsearch_probe import LEVELS, SPAN, THREADS, _search, steps_for

__all__ = ["MAX_SLOTS", "THREADS", "SPAN", "LEVELS", "layout_table",
           "stacked_bases", "max_items", "items_for", "tree_walk",
           "tree_walk_tiled",
           "tree_probe_plain", "tree_probe", "tree_get", "tree_get_config",
           "tree_probe_paged_plain", "tree_probe_paged",
           "tree_probe_paged_dma", "tree_probe_paged_pages",
           "out_of_bounds", "paged_out_of_bounds", "CHECK_RECORDS"]

# The kernels' constants (``tests/test_torch_tree_get.py`` holds them to
# the sources' ``#define`` lines); THREADS, SPAN and LEVELS, the constants
# of csrc/tree_get.cuh's tile search, come with that search's model from
# ``bsearch_probe``.
MAX_SLOTS = 16  # RT_MAX_SLOTS in csrc/tree_walk.cuh
HEAD, EDGE_FIELDS = 4, 8  # words of the table's head and of each edge


def layout_table(layout, bases: Optional[Sequence[int]] = None) -> List[int]:
    """The kernels' table: [root_len, n_root, root_steps, num_edges], per
    edge [parent, slot, cs_off, cw_off, ce_off, perm_off, n_child, steps
    over cumw_excl], then one base per searched vector, which only
    ``tree_get.cu`` reads: vector s (0 the root prefix, k + 1 edge k's
    columns) is read at ``bases[s]`` plus the layout's offsets; ``None`` is
    all zeros (the arena, or a paged arena's buffer)."""
    if layout.num_slots > MAX_SLOTS:
        raise ValueError(f"{layout.num_slots} tree nodes; the kernels take "
                         f"at most {MAX_SLOTS}")
    bases = tuple(bases) if bases is not None else (0,) * layout.num_slots
    if len(bases) != layout.num_slots:
        raise ValueError(f"{len(bases)} bases for {layout.num_slots} vectors")
    table = [layout.root_len, layout.n_root, steps_for(layout.root_len),
             len(layout.edges)]
    for e in layout.edges:
        table += [e.parent, e.slot, e.cs_off, e.cw_off, e.ce_off, e.perm_off,
                  e.n_child, steps_for(e.n_child + 1)]
    return table + list(bases)


def _check_preorder(layout) -> None:
    """``tree_get.cu`` keeps edge k's child in slot k + 1, the arena's
    pre-order packing: a layout that breaks it is refused."""
    for k, e in enumerate(layout.edges):
        if e.slot != k + 1:
            raise ValueError(f"edge {k} has child slot {e.slot}; the GET "
                             f"kernel needs slot {k + 1}")


def stacked_bases(layout, P: int) -> tuple:
    """The bases that address ``PagedArena.stacked()`` (pages of ``P``
    words) with the layout's offsets: page 0 is the root prefix at 0;
    edge k's page starts at (k + 1) P, its columns at their offsets less
    its first, ``cs_off``."""
    return (0,) + tuple((k + 1) * P - e.cs_off
                        for k, e in enumerate(layout.edges))


def max_items(num_slots: int) -> int:
    """The most probes a thread ``tree_get.cu`` walks for a tree of
    ``num_slots`` nodes (``tg_max_items``)."""
    return 8 if num_slots <= 4 else 2 if num_slots <= 8 else 1


def items_for(num_slots: int, block_rows: Optional[int] = None) -> int:
    """Probes a thread of ``tree_get.cu``'s instance for a tree of
    ``num_slots`` nodes at ``block_rows`` (``None`` the builtin 8): the
    largest the tree takes at or below the tile. Raises on a value that
    names no instance (``tree_probe``'s grid, ``tree_probe_paged``'s
    too)."""
    rows = 8 if block_rows is None else check_value("tree_probe", block_rows)
    return min(rows * 128 // THREADS, max_items(num_slots))


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


# ---------------------------------------------------------------------------
# The tile logic of csrc/tree_get.cuh as torch ops, all tiles at once: a
# tile is a row of ``qt`` (tiles, tile), values int64. The search of one
# vector (``_search``) is ``bsearch_probe``'s.
# ---------------------------------------------------------------------------

def _gather2(a, x_off: int, y_off: int, idx, span: int):
    """``tg_gather2``: a[x_off + idx] and a[y_off + idx], from staged
    slices for tiles whose index range fits ``span``."""
    lo, hi = idx.min(1).values, idx.max(1).values
    staged = hi - lo + 1 <= span
    xv, yv = a[x_off + idx].long(), a[y_off + idx].long()
    if bool(staged.any()):
        st = staged
        cols = torch.minimum(lo[st, None] + torch.arange(
            span, device=idx.device), hi[st, None])
        r = idx[st] - lo[st, None]
        xv[st] = torch.gather(a[x_off + cols].long(), 1, r)
        yv[st] = torch.gather(a[y_off + cols].long(), 1, r)
    return xv, yv, staged


def tree_walk_tiled(operand: torch.Tensor, q: torch.Tensor, layout, *,
                    tile: Optional[int] = None, span: int = SPAN,
                    levels: int = LEVELS,
                    bases: Optional[Sequence[int]] = None,
                    stats: Optional[Dict[str, int]] = None):
    """``tree_get.cu``'s walk as torch ops, tile by tile: the rows of each
    slot, equal to ``tree_walk`` on the arena. ``operand`` is read with
    ``layout_table(layout, bases)``'s addressing (the arena, a paged
    arena's buffer, or its stacked pages with ``stacked_bases``). ``tile``,
    ``span`` and ``levels`` are the kernel's unless given (the tests shrink
    them); a ragged last tile walks its last probe in the missing lanes.
    ``stats``, when given, takes the tiles and, per level, how many staged
    their bracket."""
    _check_preorder(layout)
    if not 0 <= levels <= 30 or span < 1:
        raise ValueError(f"levels {levels} (0..30) and span {span} (>= 1)")
    bases = tuple(layout_table(layout, bases)[-layout.num_slots:])
    tile = tile or THREADS * items_for(layout.num_slots)
    flat = q.reshape(-1).long()
    n = flat.numel()
    if n == 0:
        return [q.new_empty(q.shape) for _ in range(layout.num_slots)]
    nt = -(-n // tile)
    qt = torch.cat([flat, flat[-1:].expand(nt * tile - n)]).reshape(nt, tile)
    a = operand
    j, aj, _, staged = _search(a, bases[0], None, layout.root_len,
                               layout.n_root - 1, qt, span, levels)
    counts = {"tiles": nt, "root": int(staged.sum())}
    rows, locs = {0: j}, {0: qt - aj}
    for k, e in enumerate(layout.edges):
        b = bases[k + 1]
        w, start, st_g = _gather2(a, b + e.cw_off, b + e.cs_off,
                                  rows[e.parent], span)
        ws = torch.clamp(w, min=1)
        lp = locs[e.parent]
        lnew = torch.div(lp, ws, rounding_mode="trunc")
        locs[e.parent] = lnew
        tgt = a[b + e.ce_off + start].long() + (lp - lnew * ws)
        jj, cej, pj, st_s = _search(a, b + e.ce_off, b + e.perm_off,
                                    e.n_child + 1, e.n_child - 1, tgt, span,
                                    levels)
        rows[k + 1], locs[k + 1] = pj, tgt - cej
        counts[f"edge {k} gather"] = int(st_g.sum())
        counts[f"edge {k} search"] = int(st_s.sum())
    if stats is not None:
        stats.update(counts)
    return [rows[s].reshape(-1)[:n].reshape(q.shape).to(torch.int32)
            for s in range(layout.num_slots)]


# ---------------------------------------------------------------------------
# The kernel's launch.
# ---------------------------------------------------------------------------

_VP, _LL = ctypes.c_void_p, ctypes.c_longlong


@functools.lru_cache(maxsize=64)
def _ctable(layout, bases):
    """The table as a ctypes array, built once per layout and bases."""
    _check_preorder(layout)
    table = layout_table(layout, bases)
    return (ctypes.c_int * len(table))(*table)


@functools.lru_cache(maxsize=64)
def _config(layout, device: int, items: int) -> tuple:
    """``tree_get_config`` on the current card, once per layout and tile."""
    fn = build.entry("tree_get", "tree_get_config", [_VP, _VP, ctypes.c_int])
    cfg = (ctypes.c_int * 4)()
    build.check(fn(_ctable(layout, None), cfg, items), "tree_get_config")
    return tuple(cfg)


def tree_get_config(layout, *, device=None, block_rows: Optional[int] = None
                    ) -> dict:
    """The launch shape of ``tree_get`` at ``block_rows`` (``None`` the
    builtin) on the card (the current one unless ``device``): probes a
    thread, blocks an SM, SMs, shared memory bytes, and the instance's
    ``block_rows``; a launch takes min(blocks an SM x SMs, tiles)
    blocks."""
    device = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    items = items_for(layout.num_slots, block_rows)
    with torch.cuda.device(device):
        cfg = _config(layout, device.index, items)
    return dict(zip(("items", "blocks_per_sm", "sms", "smem_bytes"), cfg),
                block_rows=THREADS * items // 128)


def _get_args(operand, q, layout, bases, check: bool):
    if operand.device.type != "cuda" or q.device != operand.device:
        raise ValueError(f"tree_get runs on the card: operand on "
                         f"{operand.device}, q on {q.device}")
    if operand.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"tree_get takes int32, got {operand.dtype}/{q.dtype}")
    if not operand.is_contiguous():
        raise ValueError("tree_get: the operand must be contiguous")
    fn = build.entry("tree_get_checked" if check else "tree_get",
                     "tree_get_launch",
                     [_VP, _VP, _VP, _VP, _LL, ctypes.c_int, _VP,
                      ctypes.c_int])
    qc = q.contiguous()
    out = torch.empty((layout.num_slots,) + tuple(q.shape), dtype=torch.int32,
                      device=q.device)
    return fn, _ctable(layout, bases), qc, out


def tree_get(operand: torch.Tensor, q: torch.Tensor, layout,
             bases: Optional[tuple] = None, items: Optional[int] = None
             ) -> torch.Tensor:
    """One launch of ``csrc/tree_get.cu`` over ``operand`` (CUDA, int32,
    read with ``layout_table(layout, bases)``'s addressing), ``items``
    probes a thread (``items_for``; ``None`` the builtin tile's); counts
    nothing: the GET's wrappers count their calls. Returns (num_slots,) +
    q.shape int32."""
    if items is None:
        items = items_for(layout.num_slots)
    fn, ctable, qc, out = _get_args(operand, q, layout, bases, False)
    n = qc.numel()
    with torch.cuda.device(q.device):
        _, per_sm, sms, _ = _config(layout, torch.cuda.current_device(), items)
        blocks = min(per_sm * sms, -(-n // (THREADS * items)))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(operand.data_ptr(), ctable, qc.data_ptr(),
                       out.data_ptr(), n, blocks, stream, items), "tree_get")
    return out


CHECK_RECORDS = 64  # TG_CHECK_RECORDS: the accesses a checked launch keeps


def out_of_bounds(operand: torch.Tensor, q: torch.Tensor, layout,
                  bases: Optional[tuple] = None,
                  block_rows: Optional[int] = None) -> dict:
    """One launch of the GET's checked build (``build.VARIANTS``
    ``tree_get_checked``, ``-DTG_CHECK_BOUNDS``) as ``tree_get`` would
    launch it at ``block_rows``, every load and row store held against
    the operand, the probes and the output: ``{"count": the accesses
    outside them, "loads": [(source line, operand, byte offset, the
    operand's bytes, access bytes), ...], "out": the rows}``, the first
    ``CHECK_RECORDS`` recorded. A measurement: not counted in any
    ``launches``."""
    items = items_for(layout.num_slots, block_rows)
    fn, ctable, qc, out = _get_args(operand, q, layout, bases, True)
    n = qc.numel()
    lib = "tree_get_checked"
    cfg = build.entry(lib, "tree_get_config", [_VP, _VP, ctypes.c_int])
    arr = (ctypes.c_int * 4)()
    with torch.cuda.device(q.device):
        build.check(cfg(_ctable(layout, None), arr, items), "tree_get_config")
    blocks = min(arr[1] * arr[2], -(-max(n, 1) // (THREADS * items)))

    def launch(stream):
        build.check(fn(operand.data_ptr(), ctable, qc.data_ptr(),
                       out.data_ptr(), n, blocks, stream, items),
                    "tree_get (checked)")

    found = build.checked_run(
        build.entry(lib, "tree_get_check_set", [_VP, _VP, ctypes.c_int]),
        launch, build.entry(lib, "tree_get_check_get", [_VP, _VP]),
        (("operand", operand), ("q", qc), ("out", out)), q.device,
        CHECK_RECORDS)
    return dict(found, out=out)


def tree_probe(arena: torch.Tensor, q: torch.Tensor, layout,
               block_rows: Optional[int] = None) -> torch.Tensor:
    """arena: (layout.size,) int32; q: int32 probe positions in
    [0, join size), any shape. Returns (num_slots,) + q.shape int32.
    ``block_rows`` is the tile (``None`` the builtin)."""
    if arena.dtype != torch.int32 or q.dtype != torch.int32:
        raise TypeError(f"tree_probe takes int32, got {arena.dtype}/{q.dtype}")
    if arena.shape != (layout.size,):
        raise ValueError(f"arena {tuple(arena.shape)} vs layout size {layout.size}")
    if arena.device != q.device:
        raise ValueError(f"arena on {arena.device}, q on {q.device}")
    items = items_for(layout.num_slots, block_rows)
    if q.device.type == "cpu":
        return tree_probe_plain(arena, q, layout)
    if q.device.type != "cuda":
        raise ValueError(f"tree_probe: unsupported device {q.device}")
    out = tree_get(arena.contiguous(), q, layout, items=items)
    tree_probe.launches += 1
    count_tile(tree_probe, _tile_name(items))
    return out


tree_probe.launches = 0
tree_probe.tiles = {}


def _tile_name(items: int) -> str:
    return f"block_rows={THREADS * items // 128}"


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


def tree_probe_paged(paged, q: torch.Tensor, dma=None,
                     block_rows: Optional[int] = None) -> torch.Tensor:
    """paged: a ``PagedArena``; q: int32 probe positions in [0, join
    size), any shape. Returns (num_slots,) + q.shape int32, equal to
    ``tree_probe`` on the whole arena. ``dma=None`` is one launch over the
    pages' buffer; ``dma=True`` one launch over the stacked pages;
    ``dma=False`` one launch per page. ``launches`` counts every launch.
    ``block_rows`` is the tile of the one-launch forms (``None`` the
    builtin); the per-page form takes a thread a probe."""
    _check_paged(paged, q)
    items = items_for(paged.layout.num_slots, block_rows)
    if dma is not None:
        if dma:
            return tree_probe_paged_dma(paged, q, block_rows)
        return tree_probe_paged_pages(paged, q)
    if q.device.type == "cpu":
        return tree_probe_plain(paged.buffer, q, paged.layout)
    out = tree_get(paged.buffer, q, paged.layout, items=items)
    tree_probe_paged.launches += 1
    count_tile(tree_probe_paged, _tile_name(items))
    return out


tree_probe_paged.launches = 0
tree_probe_paged.tiles = {}


def tree_probe_paged_dma(paged, q: torch.Tensor,
                         block_rows: Optional[int] = None) -> torch.Tensor:
    """The one-launch paged walk over ``paged.stacked()`` (built once per
    ``PagedArena``), ``tree_probe_paged(..., dma=True)``: ``tree_get.cu``
    with the stacked pages' bases, at ``block_rows``."""
    _check_paged(paged, q)
    items = items_for(paged.layout.num_slots, block_rows)
    if q.device.type == "cpu":
        return tree_probe_paged_plain(paged, q, dma=True)
    stacked, P = paged.stacked()
    if stacked.numel() >= 2**31:
        raise ValueError(f"stacked pages of {stacked.numel()} words exceed "
                         "int32 offsets")
    out = tree_get(stacked, q, paged.layout, stacked_bases(paged.layout, P),
                   items)
    tree_probe_paged_dma.launches += 1
    tree_probe_paged.launches += 1
    count_tile(tree_probe_paged_dma, _tile_name(items))
    count_tile(tree_probe_paged, _tile_name(items))
    return out


tree_probe_paged_dma.launches = 0
tree_probe_paged_dma.tiles = {}


# csrc/tree_probe_paged.cu's two entries
_ROOT_ARGS = [_VP] + [ctypes.c_int] * 3 + [_VP, _VP, _LL, _VP]
_EDGE_ARGS = [_VP] * 5 + [_LL, _VP]


@functools.lru_cache(maxsize=64)
def _edge_fields(layout):
    """Each edge's ``layout_table`` fields as a ctypes array, per layout."""
    table = layout_table(layout)
    return tuple((ctypes.c_int * EDGE_FIELDS)(
        *table[HEAD + EDGE_FIELDS * k: HEAD + EDGE_FIELDS * (k + 1)])
        for k in range(len(layout.edges)))


def tree_probe_paged_pages(paged, q: torch.Tensor) -> torch.Tensor:
    """The per-page walk, ``tree_probe_paged(..., dma=False)``: one launch
    of ``csrc/tree_probe_paged.cu`` per page, each counted here and on
    ``tree_probe_paged``."""
    _check_paged(paged, q)
    if q.device.type == "cpu":
        return tree_probe_paged_plain(paged, q)
    root = build.entry("tree_probe_paged", "tpp_root_launch", _ROOT_ARGS)
    edge = build.entry("tree_probe_paged", "tpp_edge_launch", _EDGE_ARGS)
    layout = paged.layout
    qc = q.contiguous()
    n = qc.numel()
    pages = paged.pages  # views of one contiguous buffer: no copies
    fields = _edge_fields(layout)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        jl = torch.empty((2,) + tuple(q.shape), dtype=torch.int32,
                         device=q.device)
        build.check(root(pages[0].data_ptr(), layout.root_len, layout.n_root,
                         steps_for(layout.root_len), qc.data_ptr(),
                         jl.data_ptr(), n, stream), "tree_probe_paged")
        tree_probe_paged_pages.launches += 1
        tree_probe_paged.launches += 1
        rows, locs = {0: jl[0]}, {0: jl[1]}
        for k, e in enumerate(layout.edges):
            out = torch.empty((3,) + tuple(q.shape), dtype=torch.int32,
                              device=q.device)
            build.check(edge(pages[k + 1].data_ptr(), fields[k],
                             rows[e.parent].data_ptr(),
                             locs[e.parent].data_ptr(), out.data_ptr(), n,
                             stream), "tree_probe_paged")
            tree_probe_paged_pages.launches += 1
            tree_probe_paged.launches += 1
            rows[e.slot], locs[e.slot], locs[e.parent] = out[0], out[1], out[2]
    return torch.stack([rows[s] for s in range(layout.num_slots)])


tree_probe_paged_pages.launches = 0


def paged_out_of_bounds(paged, q: torch.Tensor) -> dict:
    """The per-page walk (``tree_probe_paged_pages``) through its checked
    build (``tree_probe_paged_checked``, ``-DTPP_CHECK_BOUNDS``): the same
    launches, one a page, each one's loads and stores held against its
    own page (not the buffer that holds every page), its probes or its
    parent's rows and locals, and its output. Returns the count summed over
    the launches, their first ``build.CHECK_RECORDS`` records (each
    operand named by its page or its launch), the ``launches`` and the
    rows ``out``. Raises off the card."""
    _check_paged(paged, q)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_out_of_bounds: the checked build runs on "
                         f"the card, not on {dev}")
    lib = "tree_probe_paged_checked"
    root = build.entry(lib, "tpp_root_launch", _ROOT_ARGS)
    edge = build.entry(lib, "tpp_edge_launch", _EDGE_ARGS)
    layout = paged.layout
    qc = q.contiguous()
    n = qc.numel()
    pages = paged.pages
    fields = _edge_fields(layout)
    jl = torch.empty((2,) + tuple(q.shape), dtype=torch.int32, device=dev)
    found = [build.bounds_check(lib, lambda stream: build.check(root(
        pages[0].data_ptr(), layout.root_len, layout.n_root,
        steps_for(layout.root_len), qc.data_ptr(), jl.data_ptr(), n,
        stream), "tree_probe_paged (checked)"),
        (("page 0", pages[0]), ("q", qc), ("root out", jl)), dev)]
    rows, locs = {0: jl[0]}, {0: jl[1]}
    for k, e in enumerate(layout.edges):
        out = torch.empty((3,) + tuple(q.shape), dtype=torch.int32,
                          device=dev)
        prow, ploc = rows[e.parent], locs[e.parent]
        found.append(build.bounds_check(lib, lambda stream: build.check(edge(
            pages[k + 1].data_ptr(), fields[k], prow.data_ptr(),
            ploc.data_ptr(), out.data_ptr(), n, stream),
            "tree_probe_paged (checked)"),
            ((f"page {k + 1}", pages[k + 1]), (f"edge {k} prow", prow),
             (f"edge {k} ploc", ploc), (f"edge {k} out", out)), dev))
        rows[e.slot], locs[e.slot], locs[e.parent] = out[0], out[1], out[2]
    loads = [r for f in found for r in f["loads"]][:build.CHECK_RECORDS]
    return {"count": sum(f["count"] for f in found), "loads": loads,
            "launches": len(found),
            "out": torch.stack([rows[s] for s in range(layout.num_slots)])}
