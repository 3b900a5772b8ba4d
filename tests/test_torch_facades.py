"""The PyTorch port's facades and baselines against the JAX reference, on
the CPU: ``yannakakis.binary_join`` (a deterministic sort-merge join, so
equal order included), ``yannakakis.full_join`` and its
``DeprecationWarning``, ``materialize_and_scan`` (its columns exactly, its
keep mask by distribution: the reference draws through ``jax.random``),
``PoissonSampler`` (the reference's errors, and the engine's sample bit for
bit), and the fingerprints.
"""
import warnings

import numpy as np
import pytest
import torch

import jax

from repro.core import yannakakis as r_yannakakis
from repro.core import Database
from repro.core.poisson import PoissonSampler as RPoissonSampler
from repro.engine.fingerprint import draw_fingerprint as r_draw_fingerprint
from repro.engine.spec import DrawSpec as RDrawSpec
from repro_torch.core import Database as TDatabase
from repro_torch.core import PoissonSampler, yannakakis
from repro_torch.engine import DrawSpec
from repro_torch.engine.fingerprint import (draw_fingerprint,
                                            schema_fingerprint)
from repro_torch.kernels import threefry as t_threefry

from test_torch_engine import PREFER, engines, fig2
from test_torch_kernels import star_chain
from test_torch_shred import both_queries

Z_LIMIT = 6.0


def _case(name):
    return fig2() if name == "fig2" else star_chain(int(name[-1]))


def _assert_columns_equal(want, got):
    assert list(want) == list(got)
    for v, col in want.items():
        col = np.asarray(col)
        assert col.dtype == got[v].numpy().dtype, v
        np.testing.assert_array_equal(col, got[v].numpy(), err_msg=v)


@pytest.mark.parametrize("case", ["fig2", "chain0", "chain1", "chain5"])
def test_binary_join_matches_reference_in_order(case):
    tables, q = _case(case)
    _, port, tq = engines(tables, q)
    want = r_yannakakis.binary_join(Database.from_columns(tables), q)
    got = yannakakis.binary_join(port.db, tq)
    _assert_columns_equal(want, got)


def test_binary_join_cross_product_and_empty():
    tables = {"A": {"x": np.arange(3)}, "B": {"y": np.arange(4)},
              "C": {"x": np.zeros((0,), np.int64), "z": np.zeros((0,), np.int64)}}
    for atoms in ([("A", ("x",), None), ("B", ("y",), None)],
                  [("A", ("x",), None), ("C", ("x", "z"), None)]):
        rq, tq = both_queries(atoms)
        want = r_yannakakis.binary_join(Database.from_columns(tables), rq)
        got = yannakakis.binary_join(
            TDatabase.from_columns(tables, device="cpu"), tq)
        _assert_columns_equal(want, got)


@pytest.mark.parametrize("case", ["fig2", "chain0", "chain3"])
def test_full_join_facade_matches_reference(case):
    tables, q = _case(case)
    _, port, tq = engines(tables, q)
    with pytest.warns(DeprecationWarning, match="QueryEngine"):
        want = r_yannakakis.full_join(Database.from_columns(tables), q)
    with pytest.warns(DeprecationWarning, match="QueryEngine"):
        got = yannakakis.full_join(port.db, tq)
    assert set(want) == set(got)
    for v, col in want.items():
        np.testing.assert_array_equal(np.asarray(col), got[v].numpy())
    # the facade equals the engine's own full join
    for v, col in port.full_join(tq).items():
        assert torch.equal(col, got[v])


@pytest.mark.parametrize("uniform_p", [None, 0.3])
@pytest.mark.parametrize("policy", [None, PREFER], ids=["plain", "kernels"])
def test_materialize_and_scan(policy, uniform_p):
    tables, q = star_chain(1)
    _, port, tq = engines(tables, q, policy)
    rcols, _ = r_yannakakis.materialize_and_scan(
        jax.random.key(0), Database.from_columns(tables), q,
        uniform_p=uniform_p)
    draws, kept = 60, []
    for s in range(draws):
        cols, keep = port.materialize_and_scan(t_threefry.key(s), tq,
                                               uniform_p=uniform_p)
        if s == 0:
            assert set(cols) == set(rcols)
            for v, col in rcols.items():
                np.testing.assert_array_equal(np.asarray(col), cols[v].numpy())
            p = (cols["p"].double() if uniform_p is None
                 else torch.full_like(cols["p"].double(), uniform_p))
        assert keep.dtype == torch.bool and keep.shape == p.shape
        kept.append(int(keep.sum()))
    mean, var = float(p.sum()), float((p * (1 - p)).sum())
    z = (np.mean(kept) - mean) / np.sqrt(var / draws)
    assert abs(z) < Z_LIMIT, z
    # one key, one mask
    a = yannakakis.materialize_and_scan(t_threefry.key(4), port.db, tq)[1]
    b = yannakakis.materialize_and_scan(t_threefry.key(4), port.db, tq)[1]
    assert torch.equal(a, b)


def test_poisson_sampler_raises_what_the_reference_raises():
    tables, q = star_chain(0)
    _, port, tq = engines(tables, q)
    rdb = Database.from_columns(tables)
    rq0, tq0 = both_queries([("Title", ("t", "kind", "p"), None),
                             ("Cast", ("t", "person"), None)], None)
    for cls, db, query in ((RPoissonSampler, rdb, rq0),
                           (PoissonSampler, port.db, tq0)):
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="prob_var"):
                cls(db, query)
    for cls, db, query in ((RPoissonSampler, rdb, q),
                           (PoissonSampler, port.db, tq)):
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="projection"):
                cls(db, query, project=("t", "kind"))


@pytest.mark.parametrize("policy", [None, PREFER], ids=["pernode", "fused"])
def test_poisson_sampler_equals_the_engine(policy):
    tables, q = star_chain(2)
    _, port, tq = engines(tables, q, policy)
    with pytest.warns(DeprecationWarning):
        smp = PoissonSampler(port.db, tq, kernel_policy=policy)
    assert smp.join_size == port.join_size(tq)
    assert smp.default_capacity() == port.compile(tq).default_capacity()
    assert smp.expected_k() == pytest.approx(port.compile(tq).expected_k())
    for s in range(3):
        a = smp.sample(t_threefry.key(s))
        b = port.sample(tq, t_threefry.key(s))
        assert torch.equal(a.positions, b.positions)
        assert int(a.count) == int(b.count)
        for v, col in b.columns.items():
            assert torch.equal(a.columns[v], col), v
    u = smp.uniform_sample(t_threefry.key(1), 0.2)
    w = port.uniform_sample(tq, t_threefry.key(1), 0.2)
    assert torch.equal(u.positions, w.positions)
    with pytest.warns(DeprecationWarning):
        proj = PoissonSampler(port.db, tq, project=("t", "p"))
    assert set(proj.sample(t_threefry.key(0)).columns) == {"t", "p"}


def test_schema_fingerprint_is_stable_and_shape_sensitive():
    tables, _ = star_chain(0)
    a = schema_fingerprint(TDatabase.from_columns(tables, device="cpu"))
    assert a == schema_fingerprint(TDatabase.from_columns(tables, device="cpu"))
    more = dict(tables, Comp={k: np.concatenate([v, v[:1]])
                              for k, v in tables["Comp"].items()})
    assert schema_fingerprint(TDatabase.from_columns(more, device="cpu")) != a
    wide = dict(tables, Comp={k: v.astype(np.int32)
                              for k, v in tables["Comp"].items()})
    assert schema_fingerprint(TDatabase.from_columns(wide, device="cpu")) != a
    # data values do not enter it
    other = dict(tables, Title=dict(tables["Title"],
                                    kind=tables["Title"]["kind"] + 1))
    assert schema_fingerprint(TDatabase.from_columns(other, device="cpu")) == a


@pytest.mark.parametrize("kw", [
    {}, {"rep": "usr", "method": "ptbern_flat"},
    {"project": ("t", "p"), "narrow": True, "kernels": "fused", "cap": 256,
     "acap": 512}])
def test_draw_fingerprint_has_the_reference_shape(kw):
    got = draw_fingerprint(DrawSpec(**kw))
    assert got == r_draw_fingerprint(RDrawSpec(**kw))
    assert hash(got) == hash(draw_fingerprint(DrawSpec(**kw)))
    assert got != draw_fingerprint(DrawSpec(**dict(kw, cap=(kw.get("cap")
                                                          or 0) + 128)))


def test_engine_materialize_and_scan_builds_each_call():
    tables, q = star_chain(0)
    _, port, tq = engines(tables, q, PREFER)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.materialize_and_scan(t_threefry.key(0), tq)
        port.materialize_and_scan(t_threefry.key(0), tq)
    assert port.stats.shred_builds == 0  # it bypasses the engine's caches
