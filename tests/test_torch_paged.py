"""The port's paged rung against the JAX reference, on the same numpy
inputs (on the CPU the wrappers run their plain versions).

  * The ladder: at budgets ``size, size - 1, max_page, max_page - 1`` (the
    reference's ``vmem_limit``; the port's ``arena_limit = draw_limit``)
    both packages build the same index form and pick the same
    ``(rep, narrow, route)``, and an already-packed index pages at call
    time under a smaller budget.
  * ``pack_index``: a paged index is the packed arena cut into views.
  * The paged GET, per-page and one-launch forms: exact.
  * ``fused_sample``: exact for flat PTBERN; for EXPRACE exact unless an
    arrival lies within 4 float32 ulp of a cell boundary, and every lane
    where the cells differ is checked to be one (tests/test_torch_kernels).
  * The engine's ``kernels='paged'`` draw: against the reference engine's
    under the same rule, and bit for bit against the port's fused draw.

Trees: a chain (Title -> Cast -> Comp after GYO), stars (one parent, two
children: the mixed-radix peel crosses launches), and a deep tree with a
three-child node. ``p`` is always sized from the root.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import config as r_config
from repro.core import Atom, Database, JoinQuery, build_shred, probe, sampling
from repro.engine import QueryEngine
from repro.kernels.fused_draw import fused_sample as r_fused_sample
from repro.kernels.tree_probe import tree_probe_paged as r_tree_probe_paged
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.core import build_shred as t_build_shred
from repro_torch.core import probe as t_probe
from repro_torch.core import sampling as t_sampling
from repro_torch.core import shred_from_arrays
from repro_torch.engine import QueryEngine as TQueryEngine
from repro_torch.kernels import fused_draw as t_fd
from repro_torch.kernels import threefry as t_threefry
from repro_torch.kernels import tree_probe as t_tp

from test_torch_kernels import _cells, near_boundary, ref_arrivals, star_chain
from test_torch_shred import both_queries, ref_arrays

MIXED = [0.0, 0.02, 0.3, 0.5, 0.7, 0.98, 1.0]


def star(seed, m=40, p=None):
    """R(x, y, p) with children S(x, u) and T(y, v): a star after GYO."""
    rng = np.random.default_rng(seed)
    probs = rng.beta(2, 10, m) if p is None else rng.choice(p, m)
    tables = {
        "R": {"x": rng.integers(0, 12, m), "y": rng.integers(0, 12, m),
              "p": probs},
        "S": {"x": rng.integers(0, 12, 2 * m), "u": rng.integers(0, 9, 2 * m)},
        "T": {"y": rng.integers(0, 12, m), "v": rng.integers(0, 9, m)},
    }
    q = JoinQuery((Atom.of("R", "x", "y", "p"), Atom.of("S", "x", "u"),
                   Atom.of("T", "y", "v")), prob_var="p")
    return tables, q


def deep(seed):
    """A depth-4 tree with a three-child node, p on the root."""
    rng = np.random.default_rng(seed)
    tables = {
        "A": {"a": rng.integers(0, 3, 8), "b": rng.integers(0, 3, 8),
              "p": rng.uniform(0.1, 0.6, 8)},
        "B": {"b": rng.integers(0, 3, 7), "c": rng.integers(0, 3, 7),
              "d": rng.integers(0, 3, 7)},
        "C": {"c": rng.integers(0, 3, 6), "e": rng.integers(0, 3, 6)},
        "D": {"d": rng.integers(0, 3, 5), "f": rng.integers(0, 3, 5)},
        "E": {"f": rng.integers(0, 3, 4), "g": rng.integers(0, 3, 4)},
    }
    q = JoinQuery((Atom.of("A", "a", "b", "p"), Atom.of("B", "b", "c", "d"),
                   Atom.of("C", "c", "e"), Atom.of("D", "d", "f"),
                   Atom.of("E", "f", "g")), prob_var="p")
    return tables, q


CASES = {
    "chain": lambda: star_chain(0, n_t=60),
    "chain-mixed": lambda: star_chain(
        1, n_t=60, dist_p=lambda rng, n: rng.choice(MIXED, n)),
    "star": lambda: star(0),
    "star-mixed": lambda: star(1, p=MIXED),
    "deep": lambda: deep(2),
}


def setup(case):
    """(tables, reference query, port query, reference db, port db)."""
    tables, q = CASES[case]()
    _, tq = both_queries([(a.relation, a.variables, a.alias) for a in q.atoms],
                         q.prob_var)
    return (tables, q, tq, Database.from_columns(tables),
            TDatabase.from_columns(tables, device="cpu"))


def r_policy(budget):
    return dataclasses.replace(r_config.current_policy(), prefer=True,
                               vmem_limit=budget)


def t_policy(budget):
    return KernelPolicy(prefer=True, arena_limit=budget, draw_limit=budget)


def r_params(shred):
    return sampling.fused_draw_params(shred.root.weight,
                                      shred.root.data.column("p"),
                                      shred.root_prefE)


def t_params(shred):
    return t_sampling.fused_draw_params(shred.root.weight,
                                        shred.root.data.column("p"),
                                        shred.root_prefE)


def verdicts_ref(shred):
    rep, narrow = probe.select_rep(shred, "usr")
    n = int(shred.join_size)
    routes = tuple(probe.select_draw(shred, r_params(shred), method=m, n=n)
                   for m in ("exprace", "ptbern_flat"))
    return rep, bool(narrow), routes


def verdicts_port(shred, pol):
    rep, narrow = t_probe.select_rep(shred, "usr", pol)
    n = int(shred.join_size)
    routes = tuple(t_probe.select_draw(shred, t_params(shred), method=m, n=n,
                                       policy=pol)
                   for m in ("exprace", "ptbern_flat"))
    return rep, bool(narrow), routes


# --- the ladder ---------------------------------------------------------------

@pytest.mark.parametrize("rung", ["size", "size-1", "max_page", "max_page-1",
                                  "call-time"])
@pytest.mark.parametrize("case", ["chain", "star", "deep"])
def test_ladder_matches_reference(case, rung):
    _, q, tq, rdb, tdb = setup(case)
    packed = build_shred(rdb, q)
    size, max_page = packed.packed.layout.size, packed.packed.layout.max_page
    assert max_page < size - 1
    budget = {"size": size, "size-1": size - 1, "max_page": max_page,
              "max_page-1": max_page - 1, "call-time": size - 1}[rung]
    tpol = t_policy(budget)
    tpacked = t_build_shred(tdb, tq)
    with r_config.override(r_policy(budget)):
        rshred = packed if rung == "call-time" else build_shred(rdb, q)
        want = verdicts_ref(rshred)
    tshred = tpacked if rung == "call-time" else t_build_shred(tdb, tq,
                                                               policy=tpol)
    assert ((tshred.packed is None, tshred.paged is None)
            == (rshred.packed is None, rshred.paged is None))
    assert verdicts_port(tshred, tpol) == want
    # (flat PTBERN's route also gates its n lanes on the draw budget)
    expected = {"size": ("usr_fused", True, "fused"),
                "max_page-1": ("usr", False, "pernode")}
    assert want[:2] + want[2][:1] == expected.get(rung, ("usr_paged", True,
                                                         "paged"))
    if rung == "max_page-1":
        with pytest.raises(ValueError, match="paged"):
            t_probe.select_draw(tshred, t_params(tshred), method="exprace",
                                kernels="paged", policy=tpol)


def test_paged_request_raises_out_of_regime():
    _, _, tq, _, tdb = setup("chain")
    port = TQueryEngine(tdb, device="cpu",
                        kernel_policy=KernelPolicy(prefer=True))
    with pytest.raises(ValueError, match="paged"):
        port.compile(tq, kernels="paged")
    size = port.compile(tq).shred.packed.layout.size
    off = TQueryEngine(tdb, device="cpu", kernel_policy=KernelPolicy(
        prefer=True, enabled=False, arena_limit=size - 1,
        draw_limit=size - 1))
    with pytest.raises(ValueError, match="paged"):
        off.compile(tq, kernels="paged")


# --- pack_index ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["chain", "star", "deep"])
def test_pages_are_views_of_the_packed_arena(case):
    _, q, tq, rdb, tdb = setup(case)
    whole = t_build_shred(tdb, tq)
    size = whole.packed.layout.size
    paged = t_build_shred(tdb, tq, policy=t_policy(size - 1))
    assert paged.packed is None and paged.paged is not None
    assert paged.paged.layout == whole.packed.layout
    pages = paged.paged.pages
    np.testing.assert_array_equal(torch.cat(pages).numpy(),
                                  whole.packed.arena.numpy())
    buf = paged.paged.buffer
    for (s, _), page in zip(paged.paged.layout.page_bounds(), pages):
        assert page.data_ptr() == buf.data_ptr() + 4 * s  # a view, no copy
    with r_config.override(r_policy(size - 1)):
        rpaged = build_shred(rdb, q)
    assert len(rpaged.paged.pages) == len(pages)
    for a, b in zip(rpaged.paged.pages, pages):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # Over paged_limit, or a page over the budget: no int32 index at all.
    for pol in (KernelPolicy(arena_limit=size - 1, paged_limit=size - 1),
                t_policy(paged.paged.layout.max_page - 1)):
        none = t_build_shred(tdb, tq, policy=pol)
        assert none.packed is None and none.paged is None


def test_shred_from_arrays_carries_a_paged_index():
    _, q, _, rdb, _ = setup("star")
    size = build_shred(rdb, q).packed.layout.size
    with r_config.override(r_policy(size - 1)):
        rpaged = build_shred(rdb, q)
    arrays = ref_arrays(rpaged)
    port = shred_from_arrays(arrays, device="cpu")
    assert port.packed is None and port.paged is not None
    assert ref_arrays(port)["pages"] is not None
    for a, b in zip(arrays["pages"], port.paged.pages):
        np.testing.assert_array_equal(a, b.numpy())


# --- the paged GET ------------------------------------------------------------

def _tiles(n):
    pos = np.arange(n, dtype=np.int32)
    return np.pad(pos, (0, (-n) % 128), constant_values=n - 1).reshape(-1, 128)


@pytest.mark.parametrize("dma", [False, True], ids=["per-page", "one-launch"])
@pytest.mark.parametrize("case", ["chain", "star", "star-mixed", "deep"])
def test_paged_get_matches_reference(case, dma):
    _, q, _, rdb, _ = setup(case)
    size = build_shred(rdb, q).packed.layout.size
    with r_config.override(r_policy(size - 1)):
        ref = build_shred(rdb, q)
    port = shred_from_arrays(ref_arrays(ref), device="cpu")
    n = int(ref.join_size)
    tiles = _tiles(n)
    want = np.asarray(r_tree_probe_paged(ref.paged.pages, jnp.asarray(tiles),
                                         layout=ref.paged.layout,
                                         interpret=True, dma=dma))
    got = t_tp.tree_probe_paged(port.paged, torch.from_numpy(tiles), dma=dma)
    assert got.shape == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        t_tp.tree_probe_plain(port.paged.buffer, torch.from_numpy(tiles),
                              port.paged.layout).numpy(), want)
    # Through the GET: rep 'usr_paged' on sorted random positions.
    pos = np.sort(np.random.default_rng(n).integers(0, n, 200))
    with r_config.override(r_policy(size - 1)):
        want_rows = probe.usr_get_rows_paged(ref, jnp.asarray(pos))
    got_rows = t_probe.get_rows(port, torch.from_numpy(pos), rep="usr_paged")
    for name, rows in want_rows.items():
        np.testing.assert_array_equal(np.asarray(rows), got_rows[name].numpy())


def test_paged_get_pages_a_packed_index_at_call_time():
    _, q, tq, rdb, tdb = setup("star")
    ref = build_shred(rdb, q)
    port = t_build_shred(tdb, tq)
    n = int(ref.join_size)
    pos = np.arange(n)
    tpol = t_policy(port.packed.layout.size - 1)
    assert t_probe.paged_available(port, tpol)
    got = t_probe.usr_get_rows_fused(port, torch.from_numpy(pos), tpol)
    want = probe.usr_get_rows(ref, jnp.asarray(pos))
    for name, rows in want.items():
        np.testing.assert_array_equal(np.asarray(rows), got[name].numpy())


# --- fused_sample -------------------------------------------------------------

@pytest.mark.parametrize("method", ["exprace", "ptbern_flat"])
@pytest.mark.parametrize("case", ["chain", "chain-mixed", "star",
                                  "star-mixed"])
def test_fused_sample_matches_reference(case, method):
    _, q, _, rdb, _ = setup(case)
    ref = build_shred(rdb, q)
    port = shred_from_arrays(ref_arrays(ref), device="cpu")
    params = r_params(ref)
    tparams = t_params(port)
    n = int(ref.join_size)
    cap = n + 8
    acap = 2 * n + 64 if method == "exprace" else 0
    exact = 0
    for key_seed in range(3):
        kd = jax.random.key_data(jax.random.key(key_seed)).astype(jnp.uint32)
        want = r_fused_sample(kd, params, method=method, cap=cap, acap=acap,
                              n=n, interpret=True)
        key = t_threefry.key(key_seed)
        got = t_fd.fused_sample(key, tparams, method=method, cap=cap,
                                acap=acap, n=n)
        # fused_sample is draw_core, and the fused draw's positions.
        full = t_fd.fused_draw(port.packed.arena, key, tparams,
                               layout=port.packed.layout, method=method,
                               cap=cap, acap=acap, n=n)
        for g, f in zip(got, full[1:]):
            assert torch.equal(g, f)
        if method == "exprace":
            v_ref, cells_ref = ref_arrivals(kd, params, acap)
            v_port = t_fd.arrivals(key, acap, "cpu").numpy()
            diff = np.nonzero(cells_ref != _cells(v_port, params))[0]
            if diff.size:
                assert near_boundary(v_ref, params, diff).all(), diff
                continue
        exact += 1
        for g, w, what in zip(got, want, ("positions", "count", "overflow")):
            np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                          err_msg=what)
        assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    assert exact >= 2


# --- the engine ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["exprace", "ptbern_flat"])
@pytest.mark.parametrize("case", ["chain", "star-mixed", "deep"])
def test_engine_paged_draw(case, method):
    """The index pages under ``arena_limit``; the draw budget stays the
    default, so flat PTBERN's n lanes fit it. The reference pages its
    EXPRACE draw under the same budget; its flat PTBERN paged draw would
    need n within that budget, so that one is held against the
    reference's own oracle route (``kernels='reference'``), whose
    positions are the paged draw's by construction."""
    _, q, tq, rdb, tdb = setup(case)
    size = build_shred(rdb, q).packed.layout.size
    paged = TQueryEngine(tdb, device="cpu", kernel_policy=KernelPolicy(
        prefer=True, arena_limit=size - 1))
    fused = TQueryEngine(tdb, device="cpu",
                         kernel_policy=KernelPolicy(prefer=True))
    plan = paged.compile(tq, method=method)
    assert (plan.route, plan.rep_default) == ("paged", "usr_paged")
    assert fused.compile(tq, method=method).route == "fused"
    assert "draw route=paged" in paged.explain(tq)
    full = paged.full_join(tq)
    exact = 0
    for seed in range(3):
        key = t_threefry.key(seed)
        got = paged.sample(tq, key, method=method)
        same = fused.sample(tq, key, method=method)
        ref = paged.sample(tq, key, method=method, kernels="reference")
        for other in (same, ref):
            assert torch.equal(got.positions, other.positions)
            assert int(got.count) == int(other.count)
            assert bool(got.overflow) == bool(other.overflow)
            for v in got.columns:
                assert torch.equal(got.columns[v], other.columns[v]), v
        c = int(got.count)
        for v, col in full.items():
            assert torch.equal(got.columns[v][:c], col[got.positions[:c]])
        rkey = jax.random.key(seed)
        if method == "ptbern_flat":
            want = QueryEngine(rdb).sample(q, rkey, method=method,
                                           kernels="reference")
        else:
            with r_config.override(r_policy(size - 1)):
                reng = QueryEngine(rdb)
                want = reng.sample(q, rkey, kernels="paged")
                rplan = reng.compile(q, kernels="paged")
            acap = rplan.arrival_capacity()
            kd = jax.random.key_data(rkey).astype(np.uint32)
            v_ref, cells_ref = ref_arrivals(kd, rplan._dparams, acap)
            v_port = t_fd.arrivals(key, acap, "cpu").numpy()
            diff = np.nonzero(cells_ref != _cells(v_port, plan.draw_params))[0]
            if diff.size:
                assert near_boundary(v_ref, rplan._dparams, diff).all(), diff
                continue
        exact += 1
        np.testing.assert_array_equal(np.asarray(want.positions),
                                      got.positions.numpy())
        assert int(want.count) == int(got.count)
        for v, col in want.columns.items():
            np.testing.assert_array_equal(np.asarray(col),
                                          got.columns[v].numpy(), err_msg=v)
    assert exact >= 2
    assert paged.stats.shred_builds == 1
