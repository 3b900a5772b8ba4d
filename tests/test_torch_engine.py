"""The port's engine, end to end on the CPU, against the JAX reference.

  * ``full_join`` equals the reference engine's, order included.
  * The fused route (``sample`` with kernels preferred; the reference
    engine pinned with ``kernels='reference'``) gives equal positions,
    count, overflow and columns, except where an arrival lies within 4
    float32 ulp of a cell boundary (see tests/test_torch_kernels.py).
  * The per-node route draws from torch generators, so it is checked by
    distribution: a mean-count z-test, and every sampled row equals
    ``full_join`` at its position.
  * ``select_rep``/``select_draw`` choose the reference's route under
    matching budgets; warm calls rebuild nothing; the port imports no jax
    and nothing of ``repro``; the default device is the card.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import config as r_config
from repro.core import Database, build_shred, probe, sampling
from repro.engine import QueryEngine
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.core import build_shred as t_build_shred
from repro_torch.core import estimate as t_estimate
from repro_torch.core import probe as t_probe
from repro_torch.core import sampling as t_sampling
from repro_torch.engine import QueryEngine as TQueryEngine
from repro_torch.kernels import fused_draw as t_fd
from repro_torch.kernels import threefry as t_threefry

from test_torch_kernels import _cells, near_boundary, ref_arrivals, star_chain
from test_torch_shred import both_queries

ROOT = Path(__file__).resolve().parents[1]
PREFER = KernelPolicy(prefer=True)


def engines(tables, q, kernel_policy=None):
    """The reference engine and the port's on the CPU, plus the port's
    query (the same atoms)."""
    ref = QueryEngine(Database.from_columns(tables))
    port = TQueryEngine(TDatabase.from_columns(tables, device="cpu"),
                        device="cpu", kernel_policy=kernel_policy)
    _, tq = both_queries([(a.relation, a.variables, a.alias) for a in q.atoms],
                         q.prob_var)
    return ref, port, tq


def fig2():
    from repro.core import Atom, JoinQuery

    tables = {
        "R": {"x": [1, 1, 2, 2, 3], "y": [1, 2, 1, 2, 3], "p": [0.1, 0.2, 0.6, 0.9, 0.5]},
        "S": {"u": [1, 1, 2, 3, 3, 4], "a": [1, 1, 1, 2, 2, 3],
              "x": [1, 2, 1, 1, 3, 2]},
        "T": {"v": [1, 2, 3, 4, 5, 6], "y": [4, 2, 1, 2, 1, 2]},
    }
    q = JoinQuery((Atom.of("R", "x", "y", "p"), Atom.of("S", "u", "a", "x"),
                   Atom.of("T", "v", "y")), prob_var="p")
    return tables, q


@pytest.mark.parametrize("policy", [None, PREFER], ids=["plain", "kernels"])
@pytest.mark.parametrize("case", ["fig2", "chain0", "chain1"])
def test_full_join_matches_reference(case, policy):
    tables, q = fig2() if case == "fig2" else star_chain(int(case[-1]))
    ref, port, tq = engines(tables, q, policy)
    want = ref.full_join(q)
    got = port.full_join(tq)
    assert set(want) == set(got)
    for v, col in want.items():
        assert np.asarray(col).dtype == got[v].numpy().dtype, v
        np.testing.assert_array_equal(np.asarray(col), got[v].numpy(), err_msg=v)
    assert port.join_size(tq) == int(np.asarray(col).shape[0])


@pytest.mark.parametrize("case", ["chain2", "mixed"])
def test_fused_route_sample_matches_reference(case):
    mixed = lambda rng, n: rng.choice([0.0, 0.05, 0.3, 0.5, 0.8, 1.0], n)  # noqa: E731
    tables, q = star_chain(2 if case == "chain2" else 4,
                           dist_p=mixed if case == "mixed" else None)
    ref, port, tq = engines(tables, q, PREFER)
    rplan = ref.compile(q, kernels="reference")
    tplan = port.compile(tq)
    assert tplan.route == "fused"
    assert tplan.default_capacity() == rplan.default_capacity()
    acap = rplan.arrival_capacity()
    assert tplan.arrival_capacity() == acap
    exact = 0
    for seed in range(4):
        want = ref.sample(q, jax.random.key(seed), kernels="reference")
        got = port.sample(tq, t_threefry.key(seed))
        kd = jax.random.key_data(jax.random.key(seed)).astype(np.uint32)
        v_ref, cells_ref = ref_arrivals(kd, rplan._dparams, acap)
        v_port = t_fd.arrivals(t_threefry.key(seed), acap, "cpu").numpy()
        diff = np.nonzero(cells_ref != _cells(v_port, tplan.draw_params))[0]
        if diff.size:
            assert near_boundary(v_ref, rplan._dparams, diff).all(), diff
            continue
        exact += 1
        np.testing.assert_array_equal(np.asarray(want.positions),
                                      got.positions.numpy())
        assert int(want.count) == int(got.count)
        assert bool(want.overflow) == bool(got.overflow)
        for v, col in want.columns.items():
            np.testing.assert_array_equal(np.asarray(col), got.columns[v].numpy())
    assert exact >= 2


@pytest.mark.parametrize("policy,kernels,method", [
    (None, None, "exprace"), (PREFER, "pernode", "exprace"),
    (None, None, "ptbern_flat")], ids=["plain", "narrow", "ptbern"])
def test_pernode_route_distribution_and_rows(policy, kernels, method):
    tables, q = star_chain(5, n_t=60)
    _, port, tq = engines(tables, q, policy)
    plan = port.compile(tq, kernels=kernels, method=method)
    assert plan.route == "pernode"
    assert plan._narrow == (policy is not None)
    full = port.full_join(tq, rep="usr")
    names = sorted(full)
    N = 40
    counts = []
    for seed in range(N):
        smp = port.sample(tq, t_threefry.key(seed), kernels=kernels,
                          method=method)
        assert not bool(smp.overflow)
        c = int(smp.count)
        counts.append(c)
        pos = smp.positions[:c]
        assert (torch.diff(pos) > 0).all()
        for v in names:
            np.testing.assert_array_equal(smp.columns[v][:c].numpy(),
                                          full[v][pos].numpy(), err_msg=v)
    exp = plan.expected_k()
    sd = float(t_estimate.sample_std(plan.w, plan.p))
    z = (np.mean(counts) - exp) / (sd / N ** 0.5)
    assert abs(z) < 4.5, (np.mean(counts), exp, z)


@pytest.mark.parametrize("limit", ["fits", "pages", "tiny"])
@pytest.mark.parametrize("prefer", [False, True])
def test_routes_match_reference_under_matching_budgets(limit, prefer):
    """Budgets where the arena fits, where only its pages fit (the paged
    rung), and where not even a page fits."""
    tables, q = star_chain(1)
    rdb = Database.from_columns(tables)
    layout = build_shred(rdb, q).packed.layout
    budget = {"fits": layout.size, "pages": layout.max_page,
              "tiny": 16}[limit]
    rpol = r_config.KernelPolicy(prefer=prefer, vmem_limit=budget)
    tpol = KernelPolicy(prefer=prefer, arena_limit=budget, draw_limit=budget)
    _, tq = both_queries([(a.relation, a.variables, a.alias) for a in q.atoms],
                         q.prob_var)
    tshred = t_build_shred(TDatabase.from_columns(tables, device="cpu"), tq,
                           policy=tpol)
    with r_config.override(rpol):
        rshred = build_shred(rdb, q)
        assert (rshred.paged is None) == (limit != "pages")
        assert (tshred.paged is None) == (limit != "pages")
        want_rep = probe.select_rep(rshred, "usr")
        rpar = sampling.fused_draw_params(rshred.root.weight,
                                          rshred.root.data.column("p"),
                                          rshred.root_prefE)
        want_draw = {k: probe.select_draw(rshred, rpar, method="exprace",
                                          kernels=k)
                     for k in ("auto", "pernode")
                     + (("paged",) if limit == "pages" else ())}
    tpar = t_sampling.fused_draw_params(tshred.root.weight,
                                        tshred.root.data.column("p"),
                                        tshred.root_prefE)
    assert t_probe.select_rep(tshred, "usr", tpol) == want_rep
    for k, want in want_draw.items():
        assert t_probe.select_draw(tshred, tpar, method="exprace", kernels=k,
                                   policy=tpol) == want
    if limit != "fits":
        with pytest.raises(ValueError):
            t_probe.select_draw(tshred, tpar, method="exprace",
                                kernels="fused", policy=tpol)


@pytest.mark.parametrize("policy,route,rep", [
    (KernelPolicy(prefer=True, fused_draw=False), "pernode", "usr_fused"),
    (KernelPolicy(prefer=True, enabled=False), "pernode", "usr"),
    (KernelPolicy(prefer=True, draw_limit=0), "pernode", "usr_fused"),
    (KernelPolicy(prefer=True, arena_limit=0), "pernode", "usr"),
], ids=["no-fused-draw", "disabled", "draw-limit", "arena-limit"])
def test_policy_switches_pick_routes(policy, route, rep):
    tables, q = star_chain(3)
    ref, port, tq = engines(tables, q, policy)
    plan = port.compile(tq)
    assert (plan.route, plan.rep_default) == (route, rep)
    want = ref.full_join(q)
    got = port.full_join(tq)
    for v, col in want.items():
        np.testing.assert_array_equal(np.asarray(col), got[v].numpy())
    smp = port.sample(tq, t_threefry.key(1))
    c = int(smp.count)
    pos = smp.positions[:c]
    for v in want:
        np.testing.assert_array_equal(smp.columns[v][:c].numpy(),
                                      got[v][pos].numpy())


def test_warm_calls_rebuild_nothing():
    tables, q = star_chain(0)
    _, port, tq = engines(tables, q, PREFER)
    port.full_join(tq)
    for seed in range(3):
        port.sample(tq, t_threefry.key(seed))
    port.compile(tq)
    assert port.stats.shred_builds == 1
    assert port.stats.plan_misses == 1
    assert port.stats.plan_hits == 4
    assert "draw route=fused" in port.explain(tq)
    smp = port.sample(tq, t_threefry.key(9), auto=True)
    assert not bool(smp.overflow)
    assert int(smp.valid().sum()) == int(smp.count)
    assert port.stats.shred_builds == 1


def test_empty_join_samples_nothing():
    tables = {"Title": {"t": np.arange(3), "p": np.full(3, 0.5)},
              "Cast": {"t": np.array([7, 8]), "person": np.array([1, 2])}}
    _, tq = both_queries([("Title", ("t", "p"), None),
                          ("Cast", ("t", "person"), None)], "p")
    port = TQueryEngine(TDatabase.from_columns(tables, device="cpu"),
                        device="cpu", kernel_policy=PREFER)
    assert port.join_size(tq) == 0
    smp = port.sample(tq, t_threefry.key(0))
    assert int(smp.count) == 0 and not bool(smp.valid().any())
    assert all(c.shape == (0,) for c in port.full_join(tq).values())


def test_ptbern_fused_route_matches_reference_exactly():
    tables, q = star_chain(6)
    ref, port, tq = engines(tables, q, PREFER)
    assert port.compile(tq, method="ptbern_flat").route == "fused"
    for seed in range(3):
        want = ref.sample(q, jax.random.key(seed), method="ptbern_flat",
                          kernels="reference")
        got = port.sample(tq, t_threefry.key(seed), method="ptbern_flat")
        np.testing.assert_array_equal(np.asarray(want.positions),
                                      got.positions.numpy())
        assert int(want.count) == int(got.count)
        assert bool(want.overflow) == bool(got.overflow)
        for v, col in want.columns.items():
            np.testing.assert_array_equal(np.asarray(col), got.columns[v].numpy())


def test_paged_and_unported_routes_raise():
    """The paged rung runs (where the index pages); a CSR GET of an index
    built without CSR columns raises."""
    tables, q = star_chain(0)
    _, port, tq = engines(tables, q, PREFER)
    shred = port.compile(tq).shred
    size = shred.packed.layout.size
    paged = TQueryEngine(port.db, device="cpu", kernel_policy=KernelPolicy(
        prefer=True, arena_limit=size - 1, draw_limit=size - 1))
    plan = paged.compile(tq, kernels="paged")
    assert (plan.route, plan.rep_default) == ("paged", "usr_paged")
    smp = paged.sample(tq, t_threefry.key(3), kernels="paged")
    want = port.sample(tq, t_threefry.key(3))
    assert torch.equal(smp.positions, want.positions)
    for v, col in want.columns.items():
        assert torch.equal(smp.columns[v], col)
    pos = torch.arange(int(shred.join_size))
    for name, rows in t_probe.get_rows(shred, pos, rep="usr").items():
        assert torch.equal(t_probe.get_rows(shred, pos, rep="usr_paged")[name],
                           rows)
    with pytest.raises(AssertionError, match="CSR"):
        t_probe.get_rows(shred, torch.arange(4), rep="csr")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables, q = star_chain(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TDatabase.from_columns(tables)
    db = TDatabase.from_columns(tables, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TQueryEngine(db)
    with pytest.raises(ValueError):
        TQueryEngine(db, device="meta")


def test_import_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.engine, repro_torch.core, repro_torch.config\n"
            "import repro_torch.kernels.build, repro_torch.kernels.fused_draw\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.tree_probe\n"
            "import repro_torch.kernels.bsearch_probe\n"
            "import repro_torch.kernels.threefry, repro_torch.core.probe\n"
            "from repro_torch.kernels.fused_draw import fused_sample\n"
            "from repro_torch.kernels.tree_probe import tree_probe_paged\n"
            "from repro_torch.core.shred import PagedArena\n"
            "import repro_torch.kernels.prefix_sum, repro_torch.kernels.geo_gaps\n"
            "import repro_torch.kernels.flash_decode\n"
            "import repro_torch.kernels.flash_prefill, repro_torch.kernels.ref\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('NO_JAX_OK')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "NO_JAX_OK" in r.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)")


def test_no_file_of_the_port_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not _IMPORT.match(line), f"{path}:{i}: {line}"
