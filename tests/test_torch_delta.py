"""The port's snapshots and incremental reshred against the JAX reference.

The same numpy tables and deltas go into ``repro`` and ``repro_torch`` (on
the CPU):

  * ``Database.apply``: versions, sharing of untouched relations, the
    survivors-then-inserts layout and its validation errors; every column
    equal to the reference's, dtypes included;
  * ``reshred_incremental`` for ``usr``, ``csr`` and ``both``, seeded and
    over property seeds: every array equal to the reference's reshred and
    to the port's own build of the post-delta snapshot, array for array
    and dtype for dtype, the int32 arena or pages included (integer stages
    and the copied ``p`` exactly);
  * ``QueryEngine.apply_delta`` upgrades warm entries with zero rebuilds,
    draws equal a fresh engine's on the same snapshot, untouched queries
    are re-keyed for free, ``rebind`` invalidates, and a delta that moves
    an arena across ``draw_limit`` flips the route as a fresh plan would.
"""
import numpy as np
import pytest
import torch

from _optional import given, settings, st  # hypothesis, or skip shims

from repro.core import Database, build_shred
from repro.core.delta import DeltaBatch, RelationDelta
from repro.core.shred import reshred_incremental
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.core import build_shred as t_build_shred
from repro_torch.core import reshred_incremental as t_reshred
from repro_torch.core.delta import DeltaBatch as TDeltaBatch
from repro_torch.core.delta import RelationDelta as TRelationDelta
from repro_torch.engine import CacheStats
from repro_torch.engine import QueryEngine as TQueryEngine
from repro_torch.kernels import threefry

from test_torch_shred import assert_same, both_queries, ref_arrays

PREFER = KernelPolicy(prefer=True)
Q3 = [("R", ("x", "p"), None), ("S", ("x", "y"), None),
      ("T", ("y", "z"), None)]


def _tables(seed=11, nr=90, ns=140, nt=60):
    rng = np.random.default_rng(seed)
    return {
        "R": {"x": rng.integers(0, 12, nr), "p": rng.random(nr) * 0.5},
        "S": {"x": rng.integers(0, 12, ns), "y": rng.integers(0, 9, ns)},
        "T": {"y": rng.integers(0, 9, nt), "z": np.arange(nt)},
    }


def _random_spec(tables, seed, max_ins=6, max_del=5):
    """A random multi-relation delta as ``DeltaBatch.of`` keywords: per
    relation inserts (new and existing key values) and deletes (chained
    rows, group heads and singletons all get hit across seeds)."""
    rng = np.random.default_rng(seed)
    gens = {
        "R": lambda k: {"x": rng.integers(0, 15, k), "p": rng.random(k)},
        "S": lambda k: {"x": rng.integers(0, 15, k),
                        "y": rng.integers(0, 11, k)},
        "T": lambda k: {"y": rng.integers(0, 11, k),
                        "z": rng.integers(0, 99, k)},
    }
    spec = {}
    for name, cols in tables.items():
        if rng.random() < 0.25:
            continue  # leave this relation untouched
        n = len(next(iter(cols.values())))
        ins = int(rng.integers(0, max_ins + 1))
        dele = int(rng.integers(0, min(max_del, n) + 1))
        if ins == 0 and dele == 0:
            continue
        s = {}
        if ins:
            s["insert"] = gens[name](ins)
        if dele:
            s["delete"] = rng.choice(n, size=dele, replace=False)
        spec[name] = s
    if not spec:  # a batch touches at least one relation
        spec["S"] = {"insert": gens["S"](1)}
    return spec


def _applied(tables, spec):
    """The tables after ``spec``, by numpy alone (survivors, then inserts
    cast to the column's dtype)."""
    out = {}
    for name, cols in tables.items():
        s = spec.get(name)
        if s is None:
            out[name] = cols
            continue
        n = len(next(iter(cols.values())))
        keep = np.ones(n, bool)
        if "delete" in s:
            keep[np.asarray(s["delete"])] = False
        out[name] = {c: np.concatenate(
            [np.asarray(v)[keep],
             np.asarray(s.get("insert", {}).get(c, []))
             .astype(np.asarray(v).dtype)]) for c, v in cols.items()}
    return out


def check_reshred(tables, atoms, prob_var, specs, rep, chained=False,
                  policy=None):
    """Each delta of ``specs`` through both packages' ``reshred_incremental``
    (from the base index, or chained from the last result) and through the
    port's build of the post-delta snapshot: all three equal."""
    rq, tq = both_queries(atoms, prob_var)
    rdb = Database.from_columns(tables)
    tdb = TDatabase.from_columns(tables, device="cpu")
    kw = {} if policy is None else {"policy": policy}
    rcur = build_shred(rdb, rq, rep=rep)
    tcur = t_build_shred(tdb, tq, rep=rep, **kw)
    if policy is None:  # the reference packs under its own policy
        assert_same(ref_arrays(rcur), ref_arrays(tcur))
    for spec in specs:
        rnew = reshred_incremental(rcur, rdb, rq, DeltaBatch.of(**spec))
        tnew = t_reshred(tcur, tdb, tq, TDeltaBatch.of(**spec), **kw)
        tdb_next = tdb.apply(TDeltaBatch.of(**spec))
        fresh = t_build_shred(tdb_next, tq, rep=rep, **kw)
        got = ref_arrays(tnew)
        if policy is None:
            assert_same(ref_arrays(rnew), got)
        assert_same(ref_arrays(fresh), got)
        # given the new snapshot, the index shares its columns
        shared = t_reshred(tcur, tdb, tq, TDeltaBatch.of(**spec), **kw,
                           new_db=tdb_next)
        assert_same(ref_arrays(shared), got)
        if chained:
            rcur, tcur = rnew, tnew
            rdb, tdb = rdb.apply(DeltaBatch.of(**spec)), tdb_next
    return tcur


def assert_same_db(rdb, tdb):
    assert rdb.version == tdb.version
    assert set(rdb.relations) == set(tdb.relations)
    for name, rel in rdb.relations.items():
        for c, col in rel.columns.items():
            got = tdb.relations[name].columns[c].numpy()
            want = np.asarray(col)
            assert got.dtype == want.dtype, (name, c, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}.{c}")


# -- Database.apply ----------------------------------------------------------

def test_apply_versions_and_sharing():
    tables = _tables()
    tdb = TDatabase.from_columns(tables, device="cpu")
    assert tdb.version == 0
    delta = TDeltaBatch.of(S={"insert": {"x": [1], "y": [2]}})
    tdb1 = tdb.apply(delta)
    assert tdb1.version == 1 and tdb.version == 0  # immutable snapshots
    assert tdb1.relations["R"] is tdb.relations["R"]
    assert tdb1.relations["T"] is tdb.relations["T"]
    assert tdb1.relations["S"] is not tdb.relations["S"]
    assert tdb1.relations["S"].num_rows == tdb.relations["S"].num_rows + 1
    assert tdb1.apply(delta).version == 2
    assert tdb1.device == tdb.device and tdb1.size() == tdb.size() + 1
    rdb = Database.from_columns(tables)
    assert_same_db(rdb.apply(DeltaBatch.of(S={"insert": {"x": [1],
                                                         "y": [2]}})), tdb1)


def _as_masks(tables, spec):
    """``spec`` with its row-index deletes as boolean masks."""
    out = {}
    for name, s in spec.items():
        s = dict(s)
        if "delete" in s:
            m = np.zeros(len(next(iter(tables[name].values()))), bool)
            m[s["delete"]] = True
            s["delete"] = m
        out[name] = s
    return out


@pytest.mark.parametrize("form", ["indices", "masks"])
@pytest.mark.parametrize("seed", range(4))
def test_apply_matches_reference(seed, form):
    tables = _tables(seed)
    spec = _random_spec(tables, 100 + seed)
    if form == "masks":
        spec = _as_masks(tables, spec)
    rdb = Database.from_columns(tables).apply(DeltaBatch.of(**spec))
    tdb = TDatabase.from_columns(tables, device="cpu").apply(
        TDeltaBatch.of(**spec))
    assert_same_db(rdb, tdb)
    want = _applied(tables, spec)
    for name, cols in want.items():
        for c, col in cols.items():
            np.testing.assert_array_equal(
                tdb.relations[name].columns[c].numpy(), col)


def test_apply_layout_is_survivors_then_inserts():
    tables = {"A": {"k": [10, 11, 12, 13], "f": [0.5, 1.5, 2.5, 3.5]}}
    spec = {"A": {"delete": [1], "insert": {"k": [99], "f": [7]}}}
    tdb = TDatabase.from_columns(tables, device="cpu").apply(
        TDeltaBatch.of(**spec))
    assert tdb.relations["A"].column("k").tolist() == [10, 12, 13, 99]
    # inserts take the column's dtype
    assert tdb.relations["A"].column("f").dtype == torch.float64
    assert_same_db(Database.from_columns(tables).apply(DeltaBatch.of(**spec)),
                   tdb)


_INVALID = {
    "unknown relation": (lambda D, R: D.of(B={"delete": [0]}), KeyError,
                         "unknown"),
    "missing column": (lambda D, R: D.of(A={"insert": {"k": [1]}}),
                       ValueError, "schema"),
    "ragged inserts": (lambda D, R: D.of(A={"insert": {"k": [1],
                                                       "v": [2, 3]}}),
                       ValueError, "ragged"),
    "mask length": (lambda D, R: D({"A": R(delete_mask=np.zeros(5,
                                                                np.bool_))}),
                    ValueError, "delete_mask"),
    "empty relation delta": (lambda D, R: D({"A": R()}), ValueError,
                             "empty"),
    "negative index": (lambda D, R: D.of(A={"delete": [-1]}), ValueError,
                       "out of range"),
    "index past the end": (lambda D, R: D.of(A={"delete": [2]}),
                           ValueError, "out of range"),
    "duplicate index": (lambda D, R: D.of(A={"delete": [0, 0]}),
                        ValueError, "duplicate"),
}


@pytest.mark.parametrize("case", sorted(_INVALID))
def test_apply_validation(case):
    make, exc, match = _INVALID[case]
    tables = {"A": {"k": [1, 2], "v": [3, 4]}}
    rdb = Database.from_columns(tables)
    tdb = TDatabase.from_columns(tables, device="cpu")
    with pytest.raises(exc, match=match):
        rdb.apply(make(DeltaBatch, RelationDelta))
    with pytest.raises(exc, match=match):
        tdb.apply(make(TDeltaBatch, TRelationDelta))


def test_delta_batch_bookkeeping():
    with pytest.raises(ValueError, match="at least one relation"):
        TDeltaBatch({})
    d = TDeltaBatch.of(S={"insert": {"x": [1, 2], "y": [3, 4]},
                          "delete": [0, 5, 6]}, R={"delete": [1]})
    assert d.touched() == ("R", "S") and d.size() == 6
    stamped = d.with_lsn(3)
    assert stamped.lsn == 3 and stamped.with_lsn(3).lsn == 3
    with pytest.raises(ValueError, match="restamp"):
        stamped.with_lsn(4)
    res = stamped.resolved({"R": 4, "S": 9})
    assert res.lsn == 3 and res.relations["S"].delete_mask.dtype == np.bool_
    assert res.relations["S"].delete_mask.nonzero()[0].tolist() == [0, 5, 6]
    assert res.size() == d.size()


# -- reshred_incremental ------------------------------------------------------

@pytest.mark.parametrize("rep", ["usr", "csr", "both"])
def test_reshred_matches_reference_seeded(rep):
    tables = _tables()
    specs = [_random_spec(tables, seed) for seed in range(12)]
    specs[::3] = [_as_masks(tables, s) for s in specs[::3]]  # both forms
    check_reshred(tables, Q3, "p", specs, rep)


@pytest.mark.parametrize("rep", ["usr", "csr", "both"])
@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10**9))
def test_reshred_matches_reference_property(rep, seed):
    tables = _tables()
    check_reshred(tables, Q3, "p",
                  [_random_spec(tables, seed, max_ins=8, max_del=8)], rep)


@pytest.mark.parametrize("rows", [[0], [2], [4], [0, 2, 4], [1, 3]],
                         ids=["head", "middle", "tail", "three", "two"])
def test_reshred_delete_chained_rows_csr(rows):
    """Deleting rows at the head, middle or tail of CSR same-key chains
    relinks the survivors exactly as a rebuild does."""
    tables = {"R": {"x": [5, 5, 5], "p": [0.5, 0.5, 0.5]},
              "S": {"x": [5, 5, 5, 5, 5, 7], "y": [0, 1, 2, 3, 4, 5]}}
    check_reshred(tables, [("R", ("x", "p"), None), ("S", ("x", "y"), None)],
                  "p", [{"S": {"delete": rows}}], "csr")


def test_reshred_chained_deltas():
    """A lineage of deltas merged one by one tracks builds from scratch."""
    tables = _tables(seed=3)
    specs, cur = [], tables
    for seed in range(6):
        specs.append(_random_spec(cur, 1000 + seed))
        cur = _applied(cur, specs[-1])
    check_reshred(tables, Q3, "p", specs, "both", chained=True)


def test_reshred_untouched_query_returns_base():
    tables = {"R": {"x": [1, 2], "p": [0.5, 0.5]}, "S": {"x": [1], "y": [3]},
              "Unrelated": {"w": [9]}}
    _, tq = both_queries([("R", ("x", "p"), None), ("S", ("x", "y"), None)],
                         "p")
    tdb = TDatabase.from_columns(tables, device="cpu")
    base = t_build_shred(tdb, tq)
    delta = TDeltaBatch.of(Unrelated={"insert": {"w": [1]}})
    assert t_reshred(base, tdb, tq, delta) is base
    # A delta on the child alone keeps the root's data by reference.
    new = t_reshred(base, tdb, tq, TDeltaBatch.of(S={"insert": {"x": [2],
                                                                "y": [4]}}))
    assert new.root.data is base.root.data


def _multicol_tables(seed, big):
    rng = np.random.default_rng(seed)
    hi = 1 << 40 if big else 6  # 2^40-wide ranges overflow the packing
    vals = rng.integers(0, hi, 8)
    pick = lambda n: vals[rng.integers(0, 8, n)]  # noqa: E731
    return {"R": {"a": pick(40), "b": pick(40), "p": rng.random(40)},
            "S": {"a": pick(70), "b": pick(70), "c": np.arange(70)}}, pick


@pytest.mark.parametrize("big", [False, True], ids=["packed", "dense-ids"])
def test_reshred_multicolumn_join_keys(big):
    tables, pick = _multicol_tables(5, big)
    specs = []
    for seed in range(6):
        r2 = np.random.default_rng(seed)
        specs.append({"S": {
            "insert": {"a": pick(4), "b": pick(4), "c": r2.integers(0, 9, 4)},
            "delete": r2.choice(70, 5, replace=False)},
            "R": {"insert": {"a": pick(2), "b": pick(2), "p": r2.random(2)},
                  "delete": r2.choice(40, 2, replace=False)}})
    atoms = [("R", ("a", "b", "p"), None), ("S", ("a", "b", "c"), None)]
    check_reshred(tables, atoms, "p", specs, "both")


def test_lex_searchsorted_takes_dense_ids_on_overflow():
    from repro_torch.core import shred as t_shred

    big = torch.tensor([0, 1 << 40, 1 << 41])
    cols = [big, big]
    assert t_shred._lex_scalar_keys(cols, cols) is None
    small = [torch.tensor([0, 1, 2]), torch.tensor([0, 1, 2])]
    assert t_shred._lex_scalar_keys(small, small) is not None
    q = [torch.tensor([1 << 40, 5]), torch.tensor([1 << 40, 5])]
    assert t_shred._lex_searchsorted(cols, q, right=False).tolist() == [1, 1]
    assert t_shred._lex_searchsorted(cols, q, right=True).tolist() == [2, 1]


def test_reshred_cross_product_edge():
    tables = {"R": {"x": [1, 2, 3], "p": [0.5, 0.2, 0.9]},
              "U": {"w": [10, 20, 30]}}
    check_reshred(tables, [("R", ("x", "p"), None), ("U", ("w",), None)], "p",
                  [{"U": {"insert": {"w": [40, 50]}, "delete": [1]},
                    "R": {"insert": {"x": [4], "p": [0.1]}}}], "both")


@pytest.mark.parametrize("limit", ["packed", "paged", "neither"])
def test_reshred_keeps_the_policy_verdict(limit):
    """Under a policy that pages (or refuses) the arena, the incremental
    index takes the verdict a fresh build under that policy takes."""
    tables = _tables()
    _, tq = both_queries(Q3, "p")
    size = t_build_shred(TDatabase.from_columns(tables, device="cpu"),
                         tq).packed.layout.size
    pol = {"packed": KernelPolicy(),
           "paged": KernelPolicy(arena_limit=size - 50),
           "neither": KernelPolicy(arena_limit=8)}[limit]
    specs = [_random_spec(tables, seed) for seed in range(4)]
    cur = check_reshred(tables, Q3, "p", specs, "usr", policy=pol)
    assert (cur.packed is not None, cur.paged is not None) == {
        "packed": (True, False), "paged": (False, True),
        "neither": (False, False)}[limit]


# -- the engine ----------------------------------------------------------------

def _shape_preserving_spec():
    """2 in / 2 out on S: every cached array keeps its shape."""
    return {"S": {"insert": {"x": [3, 7], "y": [1, 2]}, "delete": [0, 1]}}


def _engine(tables, policy=None):
    tdb = TDatabase.from_columns(tables, device="cpu")
    _, tq = both_queries(Q3, "p")
    return TQueryEngine(tdb, device="cpu", kernel_policy=policy), tq


@pytest.mark.parametrize("policy", [None, PREFER], ids=["plain", "kernels"])
def test_apply_delta_zero_rebuilds(policy):
    engine, q = _engine(_tables(), policy)
    engine.sample(q, threefry.key(0))
    engine.sample_batch(q, threefry.keys(0, 4))
    plan = engine.compile(q)
    route, caps = plan.route, (plan.default_capacity(),
                               plan.arrival_capacity())
    st0 = engine.stats.snapshot()
    engine.apply_delta(TDeltaBatch.of(**_shape_preserving_spec()))
    assert engine.db.version == 1
    engine.sample(q, threefry.key(1))
    engine.sample_batch(q, threefry.keys(2, 4))
    st1 = engine.stats
    assert st1.shred_builds == st0.shred_builds
    assert st1.plan_misses == st0.plan_misses
    assert st1.shred_upgrades >= 1 and st1.plan_upgrades >= 1
    assert engine.compile(q) is plan, "the plan object survives the upgrade"
    assert plan.route == route
    assert plan.default_capacity() >= caps[0]
    assert plan.arrival_capacity() >= caps[1]


@pytest.mark.parametrize("policy", [None, PREFER], ids=["plain", "kernels"])
def test_apply_delta_samples_match_fresh_engine(policy):
    tables = _tables()
    engine, q = _engine(tables, policy)
    key = threefry.key(7)
    engine.sample(q, key)  # warm the cache before the deltas
    for seed in range(3):
        spec = _random_spec(tables, 40 + seed)
        engine.apply_delta(TDeltaBatch.of(**spec))
        tables = _applied(tables, spec)
    fresh, _ = _engine(tables, policy)
    plan = engine.compile(q)
    a = engine.sample(q, key)
    b = fresh.sample(q, key, cap=plan.default_capacity(),
                     acap=plan.arrival_capacity())
    assert plan.route == fresh.compile(q).route
    assert torch.equal(a.positions, b.positions)
    assert int(a.count) == int(b.count)
    for v in b.columns:
        assert torch.equal(a.columns[v], b.columns[v]), v
    assert engine.join_size(q) == fresh.join_size(q)
    full_a, full_b = engine.full_join(q), fresh.full_join(q)
    for v in full_b:
        assert torch.equal(full_a[v], full_b[v]), v
    # The reference engine on the same snapshot gives the same full join.
    from repro.engine import QueryEngine

    rq, _ = both_queries(Q3, "p")
    want = QueryEngine(Database.from_columns(tables)).full_join(rq)
    for v, col in want.items():
        np.testing.assert_array_equal(full_a[v].numpy(), np.asarray(col))


def test_apply_delta_untouched_query_rekeyed_free():
    engine, q = _engine(_tables())
    _, q_free = both_queries([("T", ("y", "z"), None)])  # the delta skips T
    engine.full_join(q_free)
    engine.sample(q, threefry.key(0))
    st0 = engine.stats.snapshot()
    free_shred = engine.compile(q_free).shred
    engine.apply_delta(TDeltaBatch.of(**_shape_preserving_spec()))
    engine.full_join(q_free)
    st1 = engine.stats
    assert st1.shred_builds == st0.shred_builds
    assert engine.compile(q_free).shred is free_shred
    # Only the touched query's entries did upgrade work.
    assert st1.shred_upgrades == st0.shred_upgrades + 1
    assert st1.plan_upgrades == st0.plan_upgrades + 1


def test_apply_delta_orphaned_plan_upgrades_from_its_index():
    tables = _tables()
    engine, q = _engine(tables)
    engine.sample(q, threefry.key(0))
    engine._shreds.clear()  # the plan's index fell out of the cache
    engine.apply_delta(TDeltaBatch.of(**_shape_preserving_spec()))
    assert engine.stats.shred_upgrades == 1 and engine.stats.plan_upgrades == 1
    fresh, _ = _engine(_applied(tables, _shape_preserving_spec()))
    assert_same(ref_arrays(engine.compile(q).shred),
                ref_arrays(fresh.compile(q).shred))


def test_rebind_still_invalidates_identical_schema():
    engine, q = _engine(_tables())
    engine.sample(q, threefry.key(0))
    assert len(engine._plans) == 1 and len(engine._shreds) == 1
    st0 = engine.stats.snapshot()
    engine.rebind(TDatabase.from_columns(_tables(), device="cpu"))
    assert len(engine._plans) == 0 and len(engine._shreds) == 0
    engine.sample(q, threefry.key(0))
    assert engine.stats.shred_builds == st0.shred_builds + 1
    assert engine.stats.plan_misses == st0.plan_misses + 1
    with pytest.raises(ValueError, match="engine on"):
        engine.rebind(TDatabase.from_columns(_tables(), device="meta"))


def test_explain_and_cache_info_report_versions():
    engine, q = _engine(_tables())
    engine.sample(q, threefry.key(0))
    info = engine.cache_info()
    assert info["db_version"] == 0
    assert all(e["version"] == 0 for e in info["shreds"] + info["plans"])
    engine.apply_delta(TDeltaBatch.of(**_shape_preserving_spec()))
    info = engine.cache_info()
    assert info["db_version"] == 1
    assert all(e["version"] == 1 for e in info["shreds"] + info["plans"])
    out = engine.explain(q)
    assert "db version=1" in out and "upgrades" in out


def test_cache_stats_add_and_aggregate():
    a = CacheStats(shred_builds=1, plan_hits=2, shred_upgrades=3)
    b = CacheStats(shred_builds=4, plan_upgrades=5, shards_rebuilt=1)
    s = a + b
    assert (s.shred_builds, s.plan_hits, s.shred_upgrades, s.plan_upgrades,
            s.shards_rebuilt) == (5, 2, 3, 5, 1)
    assert CacheStats.aggregate([a, b, a]) == s + a
    assert CacheStats.aggregate([]) == CacheStats()
    snap = a.snapshot()
    a.plan_hits += 1
    assert snap.plan_hits == 2
    assert a.__add__(1) is NotImplemented


def test_apply_delta_flips_the_route_across_draw_limit():
    """A delta that takes the arena over ``draw_limit`` moves the plan off
    the fused draw (and a matching delete brings it back), as a fresh plan
    on each snapshot is routed; its draws equal the fresh plan's."""
    tables = _tables()
    engine, q = _engine(tables)
    size = engine.compile(q).shred.packed.layout.size
    # One S row adds 4 words to the arena (the R -> S edge's cumw_excl and
    # perm) plus its S -> T child_start and child_w: 4 in all.
    pol = KernelPolicy(prefer=True, draw_limit=size + 4 * 2)
    engine, q = _engine(tables, pol)
    key = threefry.key(5)
    assert engine.compile(q).route == "fused"
    engine.sample(q, key)
    grow = {"S": {"insert": {"x": [3, 4, 5], "y": [1, 1, 2]}}}
    for spec in (grow, {"S": {"delete": [140, 141, 142]}}):
        engine.apply_delta(TDeltaBatch.of(**spec))
        tables = _applied(tables, spec)
        fresh, _ = _engine(tables, pol)
        plan, fplan = engine.compile(q), fresh.compile(q)
        assert plan.route == fplan.route
        assert plan.shred.packed.layout.size == fplan.shred.packed.layout.size
        a = engine.sample(q, key)
        b = fresh.sample(q, key, cap=plan.default_capacity(),
                         acap=plan.arrival_capacity())
        assert torch.equal(a.positions, b.positions)
        for v in b.columns:
            assert torch.equal(a.columns[v], b.columns[v]), v
        assert (plan.route == "fused") == (spec is not grow), plan.route


def test_materialize_and_scan_csr_equals_usr():
    """M-CSYA (``rep='csr'``) materializes the same join as M-USYA."""
    from repro_torch.core import yannakakis

    tables = _tables()
    tdb = TDatabase.from_columns(tables, device="cpu")
    _, q = both_queries(Q3, "p")
    cols_c, keep_c = yannakakis.materialize_and_scan(threefry.key(3), tdb, q,
                                                     rep="csr")
    cols_u, keep_u = yannakakis.materialize_and_scan(threefry.key(3), tdb, q)
    assert torch.equal(keep_c, keep_u)
    for v, col in cols_u.items():
        assert torch.equal(cols_c[v], col), v
