"""The caching CSR walk's tiles, checked on the CPU.

``csr_walk.csr_walk_cached_tiled`` spells out ``csrc/csr_walk.cu``'s
caching kernel: tiles of probes, the runs of equal heads in each, one walk
a run staging its chain prefix within the tile's budget, a search a probe,
the per-lane fallback. Run at tiles and budgets small enough that tiles
stage, fall back and split runs, it must give the reference's
``_csr_walk_cached`` (the JAX scan, on the same numpy inputs) and the
port's plain versions exactly: a skewed head whose run spans many tiles,
weight-0 rows inside chains, offsets that fall below what the scan had
consumed (its reset), probes past a chain's end and empty runs (head -1).
Its counts of staged, fallen-back and one-probe runs are what the kernel
reports on the card (``chip_smoke.py`` phase F holds the two equal).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import probe
from repro_torch.kernels import csr_walk

CSRC = Path(csr_walk.__file__).resolve().parent / "csrc"


def chains(rng, n_rows: int, n_keys: int, skew: int = 0):
    """A child of ``n_rows`` rows (weights 0-3, about a quarter 0) in
    ``n_keys`` same-key chains, the first ``skew`` rows all on key 0:
    (weight, nxt, heads (an empty run's -1 last), key)."""
    key = rng.integers(0, n_keys, n_rows)
    key[:skew] = 0
    weight = rng.integers(0, 4, n_rows) * (rng.random(n_rows) > 0.25)
    nxt = np.full(n_rows, -1, np.int32)
    heads = np.full(n_keys + 1, -1, np.int32)
    for k in range(n_keys):
        rows = np.flatnonzero(key == k)
        if rows.size:
            heads[k] = rows[0]
            nxt[rows[:-1]] = rows[1:]
    return weight.astype(np.int64), nxt, heads, key


def probes(rng, weight, heads, key, runs: int, most: int, skewed: int = 0):
    """``runs`` runs of equal heads (the empty head among them) of 1 ..
    ``most`` probes, mostly ascending offsets from -1 to past the chain's
    weight, some descending (the scan restarts); then ``skewed`` ascending
    probes on key 0."""
    hd, idx = [], []
    for k in rng.integers(0, heads.size, runs):
        total = int(weight[key == k].sum()) if k < heads.size - 1 else 0
        m = int(rng.integers(1, most + 1))
        offs = np.sort(rng.integers(-1, total + 3, m))
        if rng.random() < 0.3:
            offs = offs[::-1]
        hd += [heads[k]] * m
        idx += offs.tolist()
    if skewed:
        total = int(weight[key == 0].sum())
        hd += [heads[0]] * skewed
        idx += np.sort(rng.integers(0, total + 2, skewed)).tolist()
    return np.asarray(hd, np.int32), np.asarray(idx, np.int64)


def reference(weight, nxt, hd, idx):
    row, rem = probe._csr_walk_cached(jnp.asarray(weight), jnp.asarray(nxt),
                                      jnp.asarray(hd), jnp.asarray(idx))
    return np.asarray(row), np.asarray(rem)


def run_all(weight, nxt, hd, idx, tile, budget):
    """The tile model, the reference and both plain versions on the same
    inputs; returns the model's stats after holding all four equal."""
    w, n = torch.as_tensor(weight), torch.as_tensor(nxt)
    h, i = torch.as_tensor(hd), torch.as_tensor(idx)
    stats = {}
    row, rem = csr_walk.csr_walk_cached_tiled(w, n, h, i, tile=tile,
                                              budget=budget, stats=stats)
    assert row.dtype == torch.int32 and rem.dtype == torch.int64
    want_row, want_rem = reference(weight, nxt, hd, idx)
    np.testing.assert_array_equal(row.numpy(), want_row)
    np.testing.assert_array_equal(rem.numpy(), want_rem)
    for plain in (csr_walk.csr_walk_cached_plain, csr_walk.csr_walk_plain):
        prow, prem = plain(w, n, h, i)
        assert torch.equal(prow, row) and torch.equal(prem, rem)
    return stats


@pytest.mark.parametrize("tile,budget", [(4, 2), (8, 3), (8, 40), (16, 8),
                                         (32, 1000), (5, 0)])
@pytest.mark.parametrize("seed", range(3))
def test_tiles_equal_the_reference(seed, tile, budget):
    """Runs of 1-12 probes over seven chains and the empty head, with a
    skewed key (120 rows) probed 90 times after them."""
    rng = np.random.default_rng(seed)
    weight, nxt, heads, key = chains(rng, 300, 7, skew=120)
    hd, idx = probes(rng, weight, heads, key, runs=30, most=12, skewed=90)
    stats = run_all(weight, nxt, hd, idx, tile, budget)
    assert sum(stats.values()) >= -(-hd.size // tile)
    assert stats["single"] > 0


def test_a_skewed_run_spans_tiles_and_stages_in_each():
    """One head of 400 rows probed 300 times in ascending order: a run in
    each of 19 tiles of 16, each restarting from the head; with room for
    the window of its 16 offsets every tile stages, with less it falls
    back and its probes resume past the staged rows."""
    rng = np.random.default_rng(11)
    weight, nxt, heads, key = chains(rng, 400, 1)
    hd = np.full(300, heads[0], np.int32)
    idx = np.sort(rng.integers(0, int(weight.sum()) + 2, 300))
    roomy = run_all(weight, nxt, hd, idx, tile=16, budget=64)
    assert roomy == {"staged": 19, "fallback": 0, "single": 0}
    tight = run_all(weight, nxt, hd, idx, tile=16, budget=4)
    assert tight["fallback"] > 0 and tight["staged"] + tight["fallback"] == 19


def test_weight_zero_rows_and_the_scans_reset():
    """A chain 0 -> 1 -> ... -> 5 of weights 1, 0, 2, 0, 0, 1: offsets that
    pass the weight-0 rows, land on them or past the chain, and an offset
    that falls below what the scan had consumed (it restarts from the
    head); an empty run of three probes; a run of one."""
    weight = np.array([1, 0, 2, 0, 0, 1, 5], np.int64)
    nxt = np.array([1, 2, 3, 4, 5, -1, -1], np.int32)
    hd = np.array([0, 0, 0, 0, 0, 0, -1, -1, -1, 6, 0, 0], np.int32)
    idx = np.array([0, 1, 2, 3, 4, 1, 0, 2, 7, 4, 0, 9], np.int64)
    for tile, budget in ((16, 8), (16, 1), (4, 2), (3, 0)):
        stats = run_all(weight, nxt, hd, idx, tile, budget)
        if tile == 16:
            assert stats["single"] == 1  # the head 6 run
            assert stats["staged"] + stats["fallback"] == 3
    row, rem = reference(weight, nxt, hd, idx)
    assert row.tolist()[:6] == [0, 2, 2, 5, -1, 2]
    assert rem.tolist()[:6] == [0, 0, 1, 0, 0, 0]


def test_empty_and_all_singleton_inputs():
    weight = np.array([2, 1], np.int64)
    nxt = np.array([1, -1], np.int32)
    empty = np.zeros(0, np.int32), np.zeros(0, np.int64)
    stats = {}
    row, rem = csr_walk.csr_walk_cached_tiled(
        torch.as_tensor(weight), torch.as_tensor(nxt),
        torch.as_tensor(empty[0]), torch.as_tensor(empty[1]), stats=stats)
    assert row.shape == rem.shape == (0,)
    assert stats == {"staged": 0, "fallback": 0, "single": 0}
    hd = np.array([0, 1, 0, 1, -1], np.int32)
    idx = np.array([2, 0, 3, 1, 0], np.int64)
    assert run_all(weight, nxt, hd, idx, tile=4, budget=2) == {
        "staged": 0, "fallback": 0, "single": 5}


def test_the_wrapper_counts_through_the_model_on_the_cpu():
    rng = np.random.default_rng(3)
    weight, nxt, heads, key = chains(rng, 200, 5)
    hd, idx = probes(rng, weight, heads, key, runs=40, most=8)
    args = [torch.as_tensor(a) for a in (weight, nxt, hd, idx)]
    stats = {}
    got = csr_walk.csr_walk_cached(*args, stats=stats)
    want_stats = {}
    want = csr_walk.csr_walk_cached_tiled(*args, stats=want_stats)
    assert stats == want_stats and stats["staged"] > 0
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert csr_walk.csr_walk_cached.launches == 0


def test_tile_constants_are_the_kernels():
    text = (CSRC / "csr_walk.cu").read_text()
    defines = {k: int(v) for k, v in
               re.findall(r"^#define (\w+) (\d+)\s*$", text, re.M)}
    assert (csr_walk.TILE, csr_walk.BUDGET) == (defines["CW_TILE"],
                                                defines["CW_BUDGET"])
    # the walkers of a tile (its runs of two or more) all get a share
    assert csr_walk.BUDGET // (csr_walk.TILE // 2) >= 1


def test_a_window_past_32_bits_falls_back():
    """Heavy rows: the staged weights are 32 bits past the first staged
    row's, so a window that passes 2^32 stops staging there and its later
    probes resume the walk on their lanes (exact all the same)."""
    weight = np.array([3, 2**31, 2**31, 5, 2**32, 7, 1], np.int64)
    nxt = np.array([1, 2, 3, 4, 5, 6, -1], np.int32)
    total = int(weight.sum())
    hd = np.zeros(8, np.int32)
    idx = np.array([0, 4, 2**31 + 3, 2**32 + 3, 2**32 + 6, 2**33 + 8,
                    total - 1, total + 5], np.int64)
    stats = run_all(weight, nxt, hd, idx, tile=8, budget=64)
    assert stats == {"staged": 0, "fallback": 1, "single": 0}
    # a window within 32 bits of the same chain stages
    near = np.array([0, 4, 2**31 + 2], np.int64)
    assert run_all(weight, nxt, hd[:3], near, tile=8, budget=64) == {
        "staged": 1, "fallback": 0, "single": 0}
