"""The batched draw kernel's tile searches, modelled on the CPU.

``csrc/fused_draw.cu`` runs every search of the draw by tiles of ascending
queries: a tile brackets its used queries' counts, stages the slice in
shared memory when it is at most ``SPAN`` wide and otherwise descends lane
by lane within the bracket; the walk goes by output tiles. The kernel
needs the card; ``fused_draw.fused_draw_tiled`` spells the same logic out
as torch ops, and these tests hold it on the CPU:

  * ``_count_tiled`` equals the plain search for ascending int32 and
    float32 vectors, any queries and any mask of used lanes, at tiles and
    spans that make both paths run;
  * the model's batch (EXPRACE, flat PTBERN; 1 and 4 keys) equals
    ``draw_core`` plus ``tree_walk`` (``fused_draw_batch_plain``), at the
    kernel's span and at a span small enough that tiles stage and fall
    back (counted by ``stats``);
  * the model's batch against the JAX package's ``sample_batch`` through
    its plain reference (``kernels='reference'``): positions, counts,
    overflow and columns equal, except where an arrival lies within 4
    float32 ulp of a cell boundary (the arrival sum is ordered
    differently; ``near_boundary``).

On the card ``chip_smoke.py`` (phase E) holds the kernel against its plain
version and its staged and fallback counts against this model's.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro_torch.core import probe as t_probe
from repro_torch.kernels import fused_draw as t_fd
from repro_torch.kernels import threefry as t_threefry

from test_torch_engine import PREFER, engines
from test_torch_kernels import _cells, near_boundary, ref_arrivals, star_chain

CSRC = Path(t_fd.__file__).resolve().parent / "csrc"
MIXED = (lambda rng, n:  # noqa: E731 - roots on both sides of p = 1/2
         rng.choice([0.0, 0.05, 0.3, 0.5, 0.8, 1.0], n))


def test_tile_constants_are_the_kernels():
    text = (CSRC / "fused_draw.cu").read_text()
    defs = {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)\s*$", text, re.M)}
    assert t_fd.SPAN == defs["FD_SPAN"]
    assert t_fd.TILE == defs["FD_THREADS"] * defs["FD_ITEMS"]


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("tile,span", [(64, 4096), (64, 250), (8, 40)])
def test_count_tiled_matches_the_plain_search(dtype, tile, span):
    rng = np.random.default_rng(tile * 31 + span)
    vec = np.sort(rng.integers(0, 5_000, 3_000)).astype(np.float64)
    qs = np.sort(rng.integers(-50, 5_100, 1_000)).astype(np.float64)
    odd = rng.random(qs.size) < 0.005  # a few lanes out of order
    qs[odd] = rng.integers(-50, 5_100, int(odd.sum()))
    use = rng.random(qs.size) < 0.8
    use[128:192] = False  # a tile with no used lane
    tv = torch.from_numpy(vec).to(dtype)
    tq = torch.from_numpy(qs).to(dtype)
    tu = torch.from_numpy(use)
    stats = {}
    got = t_fd._count_tiled(tv, tq, tu, tile, span, stats)
    want = t_fd._count_le(tv, tq)
    assert torch.equal(got[tu], want[tu])
    if span == 4096:
        assert stats["staged"] > 0 and stats["fallback"] == 0
    else:
        assert stats["staged"] > 0 and stats["fallback"] > 0


def _plan(method, dist_p=MIXED, seed=4, n_t=40):
    tables, q = star_chain(seed, n_t=n_t, dist_p=dist_p)
    _, port, tq = engines(tables, q, PREFER)
    plan = port.compile(tq, method=method)
    assert plan.route == "fused"
    kw = dict(method=method, cap=plan.default_capacity(),
              acap=plan.arrival_capacity() if method == "exprace" else 0,
              n=plan.join_size if method == "ptbern_flat" else 0)
    return plan, kw


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("method", ["exprace", "ptbern_flat"])
def test_tiled_model_equals_the_plain_draw(method, batch):
    plan, kw = _plan(method)
    pk = plan.shred.packed
    keys = t_threefry.keys(17, batch)
    want = t_fd.fused_draw_batch_plain(pk.arena, keys, plan.draw_params,
                                       layout=pk.layout, **kw)
    assert int(want[2].min()) > 0
    stats = {}
    got = t_fd.fused_draw_batch_tiled(pk.arena, keys, plan.draw_params,
                                      layout=pk.layout, tile=64, stats=stats,
                                      **kw)
    _assert_equal(got, want)
    assert stats["staged"] > 0 and stats["fallback"] == 0
    # the draw without the walk (fused_sample's model)
    pos = t_fd.fused_draw_batch_tiled(None, keys, plan.draw_params, tile=64,
                                      **kw)
    _assert_equal(pos, want[1:])


@pytest.mark.parametrize("method", ["exprace", "ptbern_flat"])
def test_tiled_model_stages_and_falls_back(method):
    """A span of 6 words: tiles whose bracket is narrow stage, the others
    descend lane by lane, and the draw is the same."""
    plan, kw = _plan(method, n_t=60)
    pk = plan.shred.packed
    keys = t_threefry.keys(23, 4)
    want = t_fd.fused_draw_batch_plain(pk.arena, keys, plan.draw_params,
                                       layout=pk.layout, **kw)
    stats = {}
    got = t_fd.fused_draw_batch_tiled(pk.arena, keys, plan.draw_params,
                                      layout=pk.layout, tile=32, span=6,
                                      stats=stats, **kw)
    _assert_equal(got, want)
    assert stats["staged"] > 0 and stats["fallback"] > 0, stats


def test_tiled_batch_matches_reference():
    tables, q = star_chain(2, dist_p=MIXED)
    ref, port, tq = engines(tables, q, PREFER)
    rplan = ref.compile(q, kernels="reference")
    tplan = port.compile(tq)
    assert tplan.route == "fused"
    acap, cap = rplan.arrival_capacity(), tplan.default_capacity()
    B = 4
    rkeys = jax.random.split(jax.random.key(29), B)
    want = ref.sample_batch(q, rkeys, kernels="reference")
    pk = tplan.shred.packed
    rows, pos, cnt, ovf = t_fd.fused_draw_batch_tiled(
        pk.arena, t_threefry.keys(29, B), tplan.draw_params,
        layout=pk.layout, method="exprace", cap=cap, acap=acap, tile=64,
        span=8)
    cols = t_probe.gather_columns(
        tplan.shred, {name: rows[:, i] for i, name in
                      enumerate(pk.layout.names)})
    exact = 0
    for b in range(B):
        kd = np.asarray(jax.random.key_data(rkeys[b])).astype(np.uint32)
        v_ref, cells_ref = ref_arrivals(kd, rplan._dparams, acap)
        v_port = t_fd.arrivals(kd, acap, "cpu").numpy()
        diff = np.nonzero(cells_ref != _cells(v_port, tplan.draw_params))[0]
        if diff.size:
            assert near_boundary(v_ref, rplan._dparams, diff).all(), diff
            continue
        exact += 1
        np.testing.assert_array_equal(np.asarray(want.positions[b]),
                                      pos[b].numpy())
        assert int(want.count[b]) == int(cnt[b])
        assert bool(want.overflow[b]) == bool(ovf[b])
        for v, col in want.columns.items():
            np.testing.assert_array_equal(np.asarray(col[b]),
                                          cols[v][b].numpy())
    assert exact >= 2
