"""The GET kernel's tile logic (``tree_walk_tiled``, the plain model of
``csrc/tree_get.cu``) against the JAX reference's walk, on the same numpy
inputs.

  * The whole walk: for the chain, star, star-mixed and deep trees of
    ``tests/test_torch_paged.py``, on sorted full joins, shuffled
    positions, sparse sorted samples, one probe and all probes equal, at
    forced small tiles, spans and pivot levels (so that both the staged
    brackets and the fallback run) and at the kernel's own: exact against
    ``repro.kernels.tree_probe.tree_walk``, and ``tree_probe`` in Pallas
    interpret mode on the full join.
  * The bracketed search alone, as a property over non-decreasing vectors
    with repeated values: max j with a[j] <= q, clamped, as the reference's
    branchless descent gives it.
  * The three operands of the one kernel (the arena, a paged arena's
    buffer, the stacked pages) address the same elements through their
    tables' bases.
  * Edge k's child is slot k + 1, which the kernel keeps rows by.
  * The wrapper's constants are the kernel's ``#define`` lines.

The kernel itself runs only on a card, where ``chip_smoke.py`` holds it
against ``tree_probe_plain``.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _optional import given, settings, st
from repro import config as r_config
from repro.core import build_shred
from repro.kernels.tree_probe import tree_probe as r_tree_probe
from repro.kernels.tree_probe import tree_walk as r_tree_walk
from repro_torch.core import PagedArena, shred_from_arrays
from repro_torch.kernels import tree_probe as t_tp

from test_torch_paged import r_policy, setup
from test_torch_shred import ref_arrays

TREES = ["chain", "star", "star-mixed", "deep"]
PROBES = ["sorted", "shuffled", "sparse", "one", "equal"]
# (tile, span, levels): tiny slices and pivot tables, brackets staged only
# when one element wide with no pivots at all, and the kernel's own.
SHAPES = {"tiny": (8, 4, 2), "small": (32, 64, 3), "span-1": (16, 1, 0),
          "kernel": (None, t_tp.SPAN, t_tp.LEVELS)}


def shreds(case):
    """The reference's shred and the port's, over the same arena."""
    _, q, _, rdb, _ = setup(case)
    ref = build_shred(rdb, q)
    return ref, shred_from_arrays(ref_arrays(ref), device="cpu")


def probes(kind, n, seed):
    rng = np.random.default_rng(seed)
    pos = {"sorted": lambda: np.arange(n),
           "shuffled": lambda: rng.permutation(n),
           "sparse": lambda: np.sort(rng.choice(n, max(1, n // 7),
                                                replace=False)),
           "one": lambda: np.array([rng.integers(0, n)]),
           "equal": lambda: np.full(301, rng.integers(0, n))}[kind]()
    return pos.astype(np.int32)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", PROBES)
@pytest.mark.parametrize("case", TREES)
def test_tiled_walk_matches_reference(case, kind, shape):
    ref, port = shreds(case)
    pos = probes(kind, int(ref.join_size), seed=len(case) + len(kind))
    want = np.stack([np.asarray(r) for r in r_tree_walk(
        ref.packed.arena, jnp.asarray(pos), ref.packed.layout)])
    tile, span, levels = SHAPES[shape]
    got = t_tp.tree_walk_tiled(port.packed.arena, torch.from_numpy(pos),
                               port.packed.layout, tile=tile, span=span,
                               levels=levels)
    assert all(r.dtype == torch.int32 and r.shape == pos.shape for r in got)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)


@pytest.mark.parametrize("case", TREES)
def test_tiled_walk_takes_both_paths(case):
    """At the tiny shape a sorted full join stages some brackets and falls
    back on others, and agrees with the Pallas kernel (interpret mode)."""
    ref, port = shreds(case)
    n = int(ref.join_size)
    pos = np.arange(n, dtype=np.int32)
    tiles = np.pad(pos, (0, (-n) % 128), constant_values=n - 1).reshape(-1, 128)
    want = np.asarray(r_tree_probe(ref.packed.arena, jnp.asarray(tiles),
                                   layout=ref.packed.layout, interpret=True))
    stats = {}
    got = t_tp.tree_walk_tiled(port.packed.arena, torch.from_numpy(tiles),
                               port.packed.layout, tile=8, span=4, levels=2,
                               stats=stats)
    np.testing.assert_array_equal(torch.stack(got).numpy(), want)
    staged = sum(v for k, v in stats.items() if k != "tiles")
    assert 0 < staged < stats["tiles"] * (len(stats) - 1), stats


def _search_case(values, queries, tile, span, levels, with_perm):
    """A non-decreasing ``values`` placed at an offset inside a larger
    arena (a perm column after it), searched by the model's tile logic;
    returns (got, want) for j, a[j] and perm[j]."""
    a = np.sort(np.asarray(values, dtype=np.int64))
    length, off = a.shape[0], 5
    cap = max(length - 2, 0) if length > 1 else 0
    perm = np.random.default_rng(length).permutation(length)
    arena = torch.from_numpy(np.concatenate(
        [np.full(off, -7), a, perm, np.full(3, 99)]).astype(np.int32))
    q = torch.as_tensor(np.asarray(queries, dtype=np.int64))
    nt = -(-q.numel() // tile)
    qt = torch.cat([q, q[-1:].expand(nt * tile - q.numel())]).reshape(nt, tile)
    j, aj, pj, _ = t_tp._search(arena, off, off + length if with_perm else None,
                                length, cap, qt, span, levels)
    want_j = torch.clamp(t_tp._descend(arena, off, length, qt), max=cap)
    got = [j, aj] + ([pj] if with_perm else [])
    want = [want_j, arena[off + want_j].long()] + (
        [arena[off + length + want_j].long()] if with_perm else [])
    return got, want


@settings(max_examples=150, deadline=None)
@given(values=st.lists(st.integers(0, 40), min_size=1, max_size=300),
       queries=st.lists(st.integers(-3, 45), min_size=1, max_size=70),
       tile=st.sampled_from([1, 3, 8, 32]),
       span=st.integers(1, 64), levels=st.integers(0, 9),
       with_perm=st.booleans(), sort_queries=st.booleans())
def test_bracketed_search_property(values, queries, tile, span, levels,
                                   with_perm, sort_queries):
    if sort_queries:
        queries = sorted(queries)
    got, want = _search_case(values, queries, tile, span, levels, with_perm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["repeats", "flat", "steps"])
def test_bracketed_search_examples(kind):
    """The property's edge cases by hand: long runs of one value, a flat
    vector (every query below, equal to or above it), and a staircase."""
    rng = np.random.default_rng(1)
    values = {"repeats": np.repeat(np.arange(0, 60, 3), 25),
              "flat": np.full(700, 11),
              "steps": np.cumsum(rng.integers(0, 3, 2000))}[kind]
    queries = np.sort(rng.integers(-2, int(values.max()) + 3, 900))
    for tile, span, levels in ((8, 4, 2), (64, 16, 5), (256, 4096, 10)):
        got, want = _search_case(values, queries, tile, span, levels, True)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["chain", "star", "deep"])
def test_three_operands_address_the_same_elements(case):
    ref, port = shreds(case)
    layout, arena = port.packed.layout, port.packed.arena
    paged = PagedArena.from_packed(port.packed)
    stacked, P = paged.stacked()
    flat = stacked.reshape(-1)
    operands = {"arena": (arena, None), "buffer": (paged.buffer, None),
                "stacked": (flat, t_tp.stacked_bases(layout, P))}
    slots = layout.num_slots
    for name, (operand, bases) in operands.items():
        # one table for every kernel: the walk's fields, then the bases
        table = t_tp.layout_table(layout, bases)
        assert table[:-slots] == t_tp.layout_table(layout)[:-slots]
        b, edge_bases = table[-slots], table[-slots + 1:]
        np.testing.assert_array_equal(operand[b:b + layout.root_len].numpy(),
                                      arena[:layout.root_len].numpy())
        H, F = t_tp.HEAD, t_tp.EDGE_FIELDS
        for k, e in enumerate(layout.edges):
            assert table[H + F * k: H + F * (k + 1)] == [
                e.parent, e.slot, e.cs_off, e.cw_off, e.ce_off, e.perm_off,
                e.n_child, t_tp.steps_for(e.n_child + 1)]
            b = edge_bases[k]
            lo, hi = e.cs_off, e.perm_off + e.n_child
            np.testing.assert_array_equal(operand[b + lo:b + hi].numpy(),
                                          arena[lo:hi].numpy())
        n = int(ref.join_size)
        pos = torch.from_numpy(probes("sorted", n, 0))
        got = t_tp.tree_walk_tiled(operand, pos, layout, tile=16, span=8,
                                   levels=2, bases=bases)
        np.testing.assert_array_equal(
            torch.stack(got).numpy(),
            t_tp.tree_probe_plain(arena, pos, layout).numpy(), err_msg=name)
    # the paged GET's default and its explicit forms, through the wrappers
    pos = torch.from_numpy(probes("sparse", int(ref.join_size), 3))
    want = t_tp.tree_probe_plain(arena, pos, layout)
    for dma in (None, False, True):
        assert torch.equal(t_tp.tree_probe_paged(paged, pos, dma=dma), want)


@pytest.mark.parametrize("case", TREES)
def test_edge_k_child_is_slot_k_plus_1(case):
    _, q, _, rdb, _ = setup(case)
    ref, port = shreds(case)
    with r_config.override(r_policy(ref.packed.layout.size - 1)):
        rpaged = build_shred(rdb, q)
    for layout in (port.packed.layout, ref.packed.layout,
                   rpaged.paged.layout):
        assert [e.slot for e in layout.edges] == list(
            range(1, len(layout.edges) + 1))
    layout = port.packed.layout
    if len(layout.edges) > 1:
        e0, e1 = layout.edges[:2]
        swapped = dataclasses.replace(layout, edges=(
            dataclasses.replace(e0, slot=e1.slot),
            dataclasses.replace(e1, slot=e0.slot)) + layout.edges[2:])
        pos = torch.zeros(3, dtype=torch.int32)
        with pytest.raises(ValueError, match="slot"):
            t_tp.tree_walk_tiled(port.packed.arena, pos, swapped)
        with pytest.raises(ValueError, match="slot"):
            t_tp._ctable(swapped, None)


def test_items_and_table_limits():
    _, port = shreds("chain")
    layout = port.packed.layout
    assert [t_tp.items_for(s) for s in (1, 2, 4, 5, 8, 9, 16)] == [
        4, 4, 4, 2, 2, 1, 1]
    pos = torch.zeros(3, dtype=torch.int32)
    for bad in (dict(levels=31), dict(levels=-1), dict(span=0),
                dict(bases=(0,))):
        with pytest.raises(ValueError):
            t_tp.tree_walk_tiled(port.packed.arena, pos, layout, **bad)
    with pytest.raises(ValueError, match="bases"):
        t_tp.layout_table(layout, (0,))
    with pytest.raises(ValueError, match="card"):
        t_tp.tree_get(port.packed.arena, torch.zeros(3, dtype=torch.int32),
                      layout)


def _defines(name: str) -> dict:
    text = (Path(t_tp.__file__).parent / "csrc" / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)\s*$", text, re.M)}


def test_constants_match_the_sources():
    """The model's defaults and the wrapper's grid are the kernel's own."""
    get, walk = _defines("tree_get.cuh"), _defines("tree_walk.cuh")
    assert (t_tp.THREADS, t_tp.SPAN, t_tp.LEVELS) == (
        get["TG_THREADS"], get["TG_SPAN"], get["TG_LEVELS"])
    assert (t_tp.MAX_SLOTS, t_tp.EDGE_FIELDS) == (
        walk["RT_MAX_SLOTS"], walk["RT_EDGE_FIELDS"])
