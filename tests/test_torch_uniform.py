"""The uniform samplers and ``uniform_sample`` of the PyTorch port, on the
CPU, against the JAX reference.

The reference draws through ``jax.random``, whose bits torch cannot give,
so the samplers (BERN, GEO, BINOM, HYBRID) are held by distribution: the
mean count of many draws within 6 standard deviations of n p, positions
ascending, distinct and below n, the overflow flag when the capacity is
too small. What is integer or numpy is held exactly: the sequential PT*
host oracle under one numpy generator, the rows of ``uniform_sample``
against the full join at their positions, the capacity policy.
"""
import numpy as np
import pytest
import torch

from repro.core import sampling as r_sampling
from repro.engine.capacity import DEFAULT_POLICY as R_POLICY
from repro_torch.core import sampling as t_sampling
from repro_torch.engine.capacity import DEFAULT_POLICY as T_POLICY
from repro_torch.kernels import threefry as t_threefry

from test_torch_engine import PREFER, engines
from test_torch_kernels import star_chain

Z_LIMIT = 6.0
SAMPLERS = ("bern", "geo", "binom", "hybrid")


def _sampler(name):
    return getattr(t_sampling, f"{name}_positions")


def check_positions(ps, n: int, cap: int) -> int:
    """Shape, sentinel, order and range of one draw; returns its count."""
    c = int(ps.count)
    pos = ps.positions
    assert pos.shape == (cap,) and pos.dtype == torch.int64
    assert 0 <= c <= cap
    assert bool((pos[c:] == n).all())
    v = pos[:c]
    assert bool((v[1:] > v[:-1]).all())  # ascending, so distinct
    assert bool(((v >= 0) & (v < n)).all())
    return c


@pytest.mark.parametrize("p", [0.05, 0.3, 0.7])
@pytest.mark.parametrize("name", SAMPLERS)
def test_uniform_sampler_distribution(name, p):
    n, draws = 3000, 40
    cap = T_POLICY.uniform_capacity(n, p)
    counts = []
    for s in range(draws):
        ps = _sampler(name)(t_threefry.key(s), p, n, cap, device="cpu")
        assert not bool(ps.overflow)
        counts.append(check_positions(ps, n, cap))
    z = (np.mean(counts) - n * p) / np.sqrt(n * p * (1 - p) / draws)
    assert abs(z) < Z_LIMIT, z
    # independent keys give independent draws
    assert len(set(counts)) > 1


@pytest.mark.parametrize("name", SAMPLERS)
def test_uniform_sampler_flags_overflow(name):
    n, p = 2000, 0.4
    cap = 128  # far below n p = 800
    ps = _sampler(name)(t_threefry.key(3), p, n, cap, device="cpu")
    assert bool(ps.overflow)
    assert check_positions(ps, n, cap) == cap


@pytest.mark.parametrize("name", SAMPLERS)
def test_uniform_sampler_extremes(name):
    n, cap = 500, 640
    none = _sampler(name)(t_threefry.key(1), 0.0, n, cap, device="cpu")
    assert int(none.count) == 0 and not bool(none.overflow)
    every = _sampler(name)(t_threefry.key(1), 1.0, n, cap, device="cpu")
    assert check_positions(every, n, cap) == n
    assert torch.equal(every.positions[:n], torch.arange(n))


@pytest.mark.parametrize("p", [0.3, 0.7])
def test_hybrid_picks_by_threshold(p):
    """HYBRID picks on the host, from a Python or a tensor p: GEO's
    sample at or below 0.5 and BERN's above."""
    n, cap = 1000, 1024
    key = t_threefry.key(8)
    want = (t_sampling.geo_positions if p <= t_sampling.HYBRID_THRESHOLD
            else t_sampling.bern_positions)(key, p, n, cap, device="cpu")
    for pp in (p, torch.tensor(p, dtype=torch.float64)):
        got = t_sampling.hybrid_positions(key, pp, n, cap, device="cpu")
        assert torch.equal(got.positions, want.positions)
        assert int(got.count) == int(want.count)
        assert bool(got.overflow) == bool(want.overflow)


def test_uniform_samplers_repeat_under_a_key():
    for name in SAMPLERS:
        a = _sampler(name)(t_threefry.key(5), 0.2, 800, 512, device="cpu")
        b = _sampler(name)(t_threefry.key(5), 0.2, 800, 512, device="cpu")
        assert torch.equal(a.positions, b.positions), name


@pytest.mark.parametrize("method", ["hybrid", "bern", "geo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pt_positions_host_matches_reference(method, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 30, 200)
    p = rng.choice([0.0, 0.01, 0.2, 0.5, 0.6, 0.99, 1.0], 200)
    want = r_sampling.pt_positions_host(np.random.default_rng(seed + 10), w,
                                        p, method)
    got = t_sampling.pt_positions_host(np.random.default_rng(seed + 10), w,
                                       p, method)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pt_positions_host_rejects_unknown_method():
    with pytest.raises(ValueError):
        t_sampling.pt_positions_host(np.random.default_rng(0), [3], [0.5],
                                     "binom")
    assert t_sampling.pt_positions_host(np.random.default_rng(0), [0, 2],
                                        [0.5, 0.0]).shape == (0,)


@pytest.mark.parametrize("n,p", [(0, 0.5), (1, 0.1), (1000, 0.05),
                                 (10**7, 0.3), (2528312, 0.7)])
def test_uniform_capacity_matches_reference(n, p):
    assert T_POLICY.uniform_capacity(n, p) == R_POLICY.uniform_capacity(n, p)


@pytest.mark.parametrize("method", SAMPLERS)
@pytest.mark.parametrize("policy", [None, PREFER], ids=["plain", "kernels"])
def test_uniform_sample_rows_are_the_join(method, policy):
    tables, q = star_chain(3)
    _, port, tq = engines(tables, q, policy)
    full = port.full_join(tq)
    n = port.join_size(tq)
    for s in range(3):
        smp = port.uniform_sample(tq, t_threefry.key(s), 0.3, method=method)
        assert smp.capacity == T_POLICY.uniform_capacity(n, 0.3)
        c = check_positions(smp, n, smp.capacity)
        pos = smp.positions[:c]
        for v, col in full.items():
            assert torch.equal(smp.columns[v][:c], col[pos]), v


def test_uniform_sample_needs_no_prob_var_and_caps():
    tables, q = star_chain(4)
    _, port, _ = engines(tables, q, PREFER)
    from test_torch_shred import both_queries

    _, tq = both_queries([("Title", ("t", "kind", "p"), None),
                          ("Cast", ("t", "person"), None)], None)
    smp = port.uniform_sample(tq, t_threefry.key(0), 0.9, cap=16,
                              method="bern")
    assert smp.capacity == 16 and bool(smp.overflow)
    assert int(smp.count) == 16
