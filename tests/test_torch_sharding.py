"""The port's sharded path against the JAX reference, in one process on
the CPU.

The reference runs its shards under ``shard_map`` over a mesh of devices;
the port drives a ``launch.mesh.Mesh`` from one host thread, here four
entries on the CPU. Held against the reference on the same numpy tables:

  * ``partition_root``, ``semijoin_filter`` and ``build_stacked``: every
    per-shard array equal (pads, weights zeroed, arenas), integer work, no
    tolerance; ``plan_shards`` verdicts on fake meshes of the same axis
    names and sizes; ``fold_shard_key`` against the reference's own
    function under named axes (1-D and (pod, data));
  * each shard's draw against the reference's single-device fused
    pipeline (``kernels='reference'``) over that shard's database under
    ``fold_in(key, s)``: equal, except where an arrival lies within 4
    float32 ulp of a cell boundary (``near_boundary``, the north star's
    tolerance); the capacities are the reference's;
  * the sharded full join against the reference's full join, order
    included; ``reshard_incremental`` and ``apply_delta`` against a fresh
    ``build_stacked``; warm calls build nothing; an empty root; the
    redraw on overflow; a degenerate mesh falls back to the single plan.
"""
import numpy as np
import pytest
import torch

import jax

from repro.core import Database, estimate
from repro.core.delta import DeltaBatch as RDeltaBatch
from repro.core.distributed import build_stacked as r_build_stacked
from repro.core.distributed import fold_shard_key as r_fold_shard_key
from repro.core.distributed import partition_root as r_partition_root
from repro.core.distributed import reshard_incremental as r_reshard
from repro.core.distributed import semijoin_filter as r_semijoin_filter
from repro.engine import CapacityPolicy as RCapacityPolicy
from repro.engine import QueryEngine
from repro.engine import plan_shards as r_plan_shards
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.core import DeltaBatch
from repro_torch.core import distributed as t_dist
from repro_torch.engine import (CapacityPolicy, CompiledPlan, QueryEngine as
                                TQueryEngine, ShardedPlan, plan_shards)
from repro_torch.kernels import threefry
from repro_torch.launch.mesh import make_mesh

from test_torch_kernels import _cells, near_boundary, ref_arrivals
from test_torch_shred import assert_same, both_queries, ref_arrays

PREFER = KernelPolicy(prefer=True)


def tables(n_r=90):
    rng = np.random.default_rng(11)
    return {
        "R": {"x": rng.integers(0, 12, n_r), "p": rng.random(n_r) * 0.5},
        "S": {"x": rng.integers(0, 16, 140), "y": rng.integers(0, 9, 140)},
        "T": {"y": rng.integers(0, 11, 60), "z": np.arange(60)},
    }


@pytest.fixture(scope="module")
def queries():
    return both_queries([("R", ("x", "p"), None), ("S", ("x", "y"), None),
                         ("T", ("y", "z"), None)], "p")


@pytest.fixture(scope="module")
def dbs():
    tab = tables()
    return Database.from_columns(tab), TDatabase.from_columns(tab,
                                                              device="cpu")


def cpu_mesh(n=4, axes=("data",), shape=None):
    return make_mesh(shape or (n,), axes, devices="cpu")


def port_engine(db, policy=PREFER):
    return TQueryEngine(db, device="cpu", kernel_policy=policy)


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


_REF_STACKS = {}


def ref_stack(rdb, rq, num_shards, rep="usr"):
    """The reference's ``build_stacked`` of the module's database, built
    once a (shard count, rep) and shared by the tests that read it."""
    key = (num_shards, rep)
    if key not in _REF_STACKS:
        _REF_STACKS[key] = r_build_stacked(rdb, rq, num_shards, rep=rep)
    return _REF_STACKS[key]


def ref_shard(stacked, s):
    """Shard ``s`` of the reference's stack (leading shard axis)."""
    return jax.tree.map(lambda x: x[s], stacked.shred)


# -- the library layer ------------------------------------------------------

@pytest.mark.parametrize("num_shards", [1, 4, 7])
def test_partition_root_matches_reference(dbs, queries, num_shards):
    rdb, tdb = dbs
    rq, tq = queries
    want = r_partition_root(rdb, rq, num_shards)
    got = t_dist.partition_root(tdb, tq, num_shards)
    assert (got.root_name, got.rows_per_shard, got.valid) == \
        (want.root_name, want.rows_per_shard, want.valid)
    assert sum(got.valid) == 90
    for ws, gs in zip(want.shards, got.shards):
        for name, rel in ws.relations.items():
            for c, col in rel.columns.items():
                np.testing.assert_array_equal(
                    _np(gs.relations[name].columns[c]), np.asarray(col),
                    err_msg=f"{name}.{c}")


def test_semijoin_filter_matches_reference(dbs, queries):
    rdb, tdb = dbs
    rq, tq = queries
    want = r_semijoin_filter(rdb, rq)
    got = t_dist.semijoin_filter(tdb, tq)
    for name, rel in want.relations.items():
        for c, col in rel.columns.items():
            np.testing.assert_array_equal(_np(got.relations[name].columns[c]),
                                          np.asarray(col))
    # S rows with x past R's keys go; T rows with y past S's too
    assert got.relations["S"].num_rows < tdb.relations["S"].num_rows
    assert got.relations["T"].num_rows < tdb.relations["T"].num_rows
    assert got.relations["R"].num_rows == 90


@pytest.mark.parametrize("num_shards,rep", [(4, "usr"), (7, "usr"),
                                            (4, "csr")])
def test_build_stacked_matches_reference(dbs, queries, num_shards, rep):
    """Every shard's index array for array (pads weight-zeroed, arenas
    re-packed), the root vectors, valid rows and join sizes; the sizes sum
    to the single engine's join."""
    rdb, tdb = dbs
    rq, tq = queries
    want, wbase = ref_stack(rdb, rq, num_shards, rep)
    got, gbase = t_dist.build_stacked(tdb, tq, num_shards, rep=rep)
    assert got.num_shards == num_shards and len(got.shreds) == num_shards
    assert (got.valid, got.join_sizes, got.root_name) == \
        (want.valid, want.join_sizes, want.root_name)
    for s in range(num_shards):
        assert_same(ref_arrays(ref_shard(want, s)), ref_arrays(got.shreds[s]),
                    f"shard {s}")
        for a, b in ((want.w, got.w), (want.p, got.p),
                     (want.prefE, got.prefE)):
            np.testing.assert_array_equal(_np(b[s]), np.asarray(a[s]))
    assert got.join_size == int(TQueryEngine(tdb, device="cpu")
                                .join_size(tq))
    assert gbase.relations["S"].num_rows == wbase.relations["S"].num_rows


def test_mixed_arena_layouts_drop_every_arena(dbs, queries):
    """One shard without an arena (a mixed int32 verdict) drops every
    shard's arena, so all shards take the per-node route."""
    _, tdb = dbs
    _, tq = queries
    part = t_dist.partition_root(t_dist.semijoin_filter(tdb, tq), tq, 4)
    built = [t_dist._build_one_shard(sdb, tq, "usr", part.valid[s], PREFER)
             for s, sdb in enumerate(part.shards)]
    assert all(b.packed is not None for b in built)
    built[2] = type(built[2])(built[2].root, built[2].root_prefE, "usr")
    st = t_dist._stack_shards(built, part, tq, 4)
    assert all(sh.packed is None and sh.paged is None for sh in st.shreds)
    plan = ShardedPlan(tq, TQueryEngine(tdb, device="cpu").compile(tq).spec,
                       cpu_mesh(), ("data",), st, kernel_policy=PREFER)
    assert plan.route == "pernode" and plan.rep == "usr"


class FakeMesh:
    """What the planner reads of a mesh: axis names and sizes."""

    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("shape,rows,floor,axes", [
    ({"data": 4}, 10_000, 8, None),
    ({"data": 8, "model": 2}, 10_000, 8, None),
    ({"model": 4}, 10_000, 8, None),
    ({"pod": 2, "data": 4, "model": 2}, 10_000, 8, None),
    ({"pod": 2, "data": 4}, 12, 2, None),
    ({"pod": 2, "data": 4}, 100, 10**9, None),
    ({"x": 3}, 100, 8, None),
    ({"data": 1}, 100, 8, None),
    ({"data": 4}, 1, 10**9, ("data",)),
    ({"pod": 2, "data": 4}, 100, 8, ("data",)),
])
def test_plan_shards_matches_reference(shape, rows, floor, axes):
    mesh = FakeMesh(**shape)
    want = r_plan_shards(mesh, rows, RCapacityPolicy(min_shard_rows=floor),
                         axes=axes)
    got = plan_shards(mesh, rows, CapacityPolicy(min_shard_rows=floor),
                      axes=axes)
    assert (got.axes, got.num_shards) == (want.axes, want.num_shards)


def test_mesh_keys_match_reference(queries):
    """The mesh enters cache keys and the draw fingerprint by its shape
    only, as in the reference; a spec's mesh and axes are not plan
    identity."""
    from repro.engine import DrawSpec as RDrawSpec
    from repro.engine import fingerprint as r_fp
    from repro_torch.engine import DrawSpec
    from repro_torch.engine import fingerprint as t_fp

    rq, tq = queries
    mesh = FakeMesh(pod=2, data=4)
    assert t_fp.mesh_fingerprint(mesh) == r_fp.mesh_fingerprint(mesh)
    assert t_fp.mesh_fingerprint(cpu_mesh(axes=("pod", "data"),
                                          shape=(2, 4))) == \
        r_fp.mesh_fingerprint(mesh)
    assert t_fp.sharded_plan_key(tq, "usr", mesh, 8, 3) == \
        r_fp.sharded_plan_key(rq, "usr", mesh, 8, 3)
    assert t_fp.sharded_executor_key(tq, "usr", "exprace", None, mesh,
                                     ("data",), 2, True, "auto") == \
        r_fp.sharded_executor_key(rq, "usr", "exprace", None, mesh,
                                  ("data",), 2, True, "auto")
    kw = dict(mesh=mesh, axes=["data"], cap=256)
    spec = DrawSpec(**kw)
    assert spec.axes == ("data",)
    assert t_fp.draw_fingerprint(spec) == \
        r_fp.draw_fingerprint(RDrawSpec(**kw))
    assert spec.plan_view("usr") == DrawSpec(rep="usr")


@pytest.mark.parametrize("sizes", [(4,), (2, 4)], ids=["data", "pod,data"])
@pytest.mark.parametrize("seed", [0, 2**40 + 7])
def test_fold_shard_key_matches_reference(sizes, seed):
    """The reference's fold_shard_key under named axes of these sizes
    (each coordinate its own key) against the port's, for every shard."""
    names = ("pod", "data")[-len(sizes):]
    key = jax.random.key(seed)

    def f(_):
        return jax.random.key_data(r_fold_shard_key(key, names))

    for name, n in zip(reversed(names), reversed(sizes)):
        f = jax.vmap(f, axis_name=name)
    want = np.asarray(f(np.zeros(sizes))).reshape(-1, 2).astype(np.uint32)
    mesh = cpu_mesh(axes=names, shape=sizes)
    got = np.stack([t_dist.fold_shard_key(threefry.key(seed), c, sizes)
                    for c in mesh.shard_coords(names)])
    np.testing.assert_array_equal(got, want)
    for s in range(want.shape[0]):
        np.testing.assert_array_equal(
            want[s], np.asarray(jax.random.key_data(
                jax.random.fold_in(key, s))).astype(np.uint32))


# -- draws ----------------------------------------------------------------------

def _same_draw(r, t):
    c = int(r.count)
    return (c == int(t.count) and bool(r.overflow) == bool(t.overflow)
            and np.array_equal(np.asarray(r.positions)[:c], _np(t.positions)[:c])
            and all(np.array_equal(np.asarray(r.columns[v])[:c],
                                   _np(t.columns[v])[:c]) for v in r.columns))


@pytest.fixture(scope="module")
def ref_shard_engines(dbs, queries):
    """The reference's engine over each of four shards' databases (one a
    shard, kept across keys: their draws compile once)."""
    rdb, _ = dbs
    rq, _ = queries
    part = r_partition_root(r_semijoin_filter(rdb, rq), rq, 4)
    return [QueryEngine(sdb) for sdb in part.shards]


@pytest.mark.parametrize("seed", [3, 8, 21])
def test_each_shard_draw_matches_reference_under_folded_key(
        dbs, queries, ref_shard_engines, seed):
    """Shard s of a sharded draw under ``key`` against the reference's plain
    fused pipeline over shard s's database under ``fold_in(key, s)``, at
    the sharded plan's capacities (the reference's: planned for the
    heaviest shard)."""
    rdb, tdb = dbs
    rq, tq = queries
    engine = port_engine(tdb)
    plan = engine.compile_sharded(tq, cpu_mesh())
    assert isinstance(plan, ShardedPlan) and plan.num_shards == 4
    assert plan.route == "fused"
    want_st, _ = ref_stack(rdb, rq, 4)
    pol = RCapacityPolicy()
    means = [float(estimate.expected_sample_size(w, p))
             for w, p in zip(want_st.w, want_st.p)]
    stds = [float(estimate.sample_std(w, p))
            for w, p in zip(want_st.w, want_st.p)]
    mass = max(float(estimate.exprace_arrival_mass(w, p))
               for w, p in zip(want_st.w, want_st.p))
    assert plan.cap == pol.plan(max(means), max(1.0, max(stds)))
    assert plan.acap == pol.plan(mass * 1.1 + 8, mass ** 0.5)

    shards, total = plan.sample_step(threefry.key(seed))
    assert int(total) == sum(int(s.count) for s in shards)
    key = jax.random.key(seed)
    for s, (reng, got) in enumerate(zip(ref_shard_engines, shards)):
        kd = jax.random.fold_in(key, s)
        want = reng.sample(rq, kd, cap=plan.cap, acap=plan.acap,
                           kernels="reference")
        if _same_draw(want, got):
            continue
        # a difference comes from an arrival at a cell boundary only
        rplan = reng.compile(rq, kernels="reference")
        v_ref, cells_ref = ref_arrivals(
            np.asarray(jax.random.key_data(kd)).astype(np.uint32),
            rplan._dparams, plan.acap)
        from repro_torch.kernels import fused_draw as t_fd
        kw = threefry.fold_in(threefry.key(seed), s)
        v_port = t_fd.arrivals(kw, plan.acap, "cpu").numpy()
        diff = np.nonzero(cells_ref != _cells(
            v_port, plan.plans[s].draw_params))[0]
        assert diff.size and near_boundary(v_ref, rplan._dparams, diff).all()
    # the gathered sample: the shards' valid lanes in shard order, global
    # positions, and every tuple a tuple of the join
    smp = engine.sample(tq, threefry.key(seed), mesh=cpu_mesh())
    k = int(smp.count)
    assert k == int(total) and smp.positions.shape == (4 * plan.cap,)
    pos = np.concatenate([_np(s.positions)[:int(s.count)] + base
                          for s, base in zip(shards, plan._bases)])
    np.testing.assert_array_equal(_np(smp.positions)[:k], pos)
    assert not _np(smp.positions)[k:].any()
    full = engine.full_join(tq)
    for v in full:
        np.testing.assert_array_equal(_np(full[v])[pos], _np(smp.columns[v])[:k])


@pytest.mark.parametrize("policy", [PREFER, None], ids=["fused", "pernode"])
def test_sharded_batch_lanes_equal_single_draws(dbs, queries, policy):
    """Lane b of a sharded batch equals the sharded draw under keys[b], on
    the fused route and on the per-node route a shard."""
    _, tdb = dbs
    _, tq = queries
    engine = port_engine(tdb, policy)
    mesh = cpu_mesh()
    assert engine.compile_sharded(tq, mesh).route == \
        ("fused" if policy else "pernode")
    keys = threefry.keys(4, 5)
    batch = engine.sample_batch(tq, keys, mesh=mesh)
    assert batch.positions.shape[0] == 5 and batch.count.shape == (5,)
    for b in range(5):
        one = engine.sample(tq, keys[b], mesh=mesh)
        assert torch.equal(batch.positions[b], one.positions)
        assert int(batch.count[b]) == int(one.count)
        for v, col in one.columns.items():
            assert torch.equal(batch.columns[v][b], col), v


def test_sharded_sample_statistics(dbs, queries):
    """Mean count of 40 sharded draws within 4.5 sd of E[k] (the
    reference's own test), and the plan's E[k] is the single plan's."""
    _, tdb = dbs
    _, tq = queries
    engine = port_engine(tdb)
    mesh = cpu_mesh()
    plan = engine.compile_sharded(tq, mesh)
    single = engine.compile(tq)
    counts = [int(engine.sample(tq, threefry.key(i), mesh=mesh).count)
              for i in range(40)]
    exp = single.expected_k()
    sd = float(estimate.sample_std(np.asarray(single.w), np.asarray(single.p)))
    z = (np.mean(counts) - exp) / (sd / 40 ** 0.5)
    assert abs(z) < 4.5, (np.mean(counts), exp, z)
    assert plan.expected_k() == pytest.approx(exp)


@pytest.mark.parametrize("n", [4, 7])
def test_sharded_full_join_matches_reference(dbs, queries, n):
    """The shards' flattens concatenate to the reference's full join, order
    included (7 shards: pads in the last)."""
    rdb, tdb = dbs
    rq, tq = queries
    want = QueryEngine(rdb).full_join(rq)
    got = port_engine(tdb).full_join(tq, mesh=cpu_mesh(n), axes=("data",))
    assert set(got) == set(want)
    for v, col in want.items():
        np.testing.assert_array_equal(_np(got[v]), np.asarray(col), err_msg=v)


# -- updates ----------------------------------------------------------------------

def _deltas(n_r):
    """A delta inside the last shard's block (the last root row out, one
    in: the partition stands) and one of the children."""
    root = {"R": {"insert": {"x": [5], "p": [0.25]}, "delete": [n_r - 1]}}
    child = {"S": {"insert": {"x": [3, 7], "y": [1, 2]}, "delete": [0, 1]}}
    return [(root, 3, 1), (child, 0, 4)]


@pytest.mark.parametrize("which", [0, 1], ids=["root block", "children"])
def test_reshard_incremental_equals_fresh_build(dbs, queries, which):
    rdb, tdb = dbs
    rq, tq = queries
    spec, reused, rebuilt = _deltas(90)[which]
    st, base = t_dist.build_stacked(tdb, tq, 4)
    new_db = tdb.apply(DeltaBatch.of(**spec))
    got, _, n_re, n_rb = t_dist.reshard_incremental(st, base, new_db, tq, 4)
    fresh, _ = t_dist.build_stacked(new_db, tq, 4)
    r_st, r_base = ref_stack(rdb, rq, 4)
    _, _, w_re, w_rb = r_reshard(r_st, r_base,
                                 rdb.apply(RDeltaBatch.of(**spec)), rq, 4)
    assert (n_re, n_rb) == (w_re, w_rb) == (reused, rebuilt)
    assert got.join_sizes == fresh.join_sizes and got.valid == fresh.valid
    for s in range(4):
        assert_same(ref_arrays(fresh.shreds[s]), ref_arrays(got.shreds[s]),
                    f"shard {s}")
    if reused:
        assert got.shreds[0] is st.shreds[0]


def test_apply_delta_upgrades_a_sharded_plan(dbs, queries):
    _, tdb = dbs
    _, tq = queries
    engine = port_engine(tdb)
    mesh = cpu_mesh()
    plan = engine.compile_sharded(tq, mesh)
    engine.sample(tq, threefry.key(1), mesh=mesh)
    st0 = engine.stats.snapshot()
    for spec, reused, rebuilt in _deltas(90):
        before = engine.stats.snapshot()
        engine.apply_delta(DeltaBatch.of(**spec))
        st = engine.stats
        assert (st.shards_reused - before.shards_reused,
                st.shards_rebuilt - before.shards_rebuilt) == (reused, rebuilt)
    assert engine.compile_sharded(tq, mesh) is plan
    assert st.shred_builds == st0.shred_builds
    assert st.plan_upgrades == st0.plan_upgrades + 2
    fresh = port_engine(engine.db)
    fplan = fresh.compile_sharded(tq, mesh)
    for s in range(4):
        assert_same(ref_arrays(fplan.stacked.shreds[s]),
                    ref_arrays(plan.stacked.shreds[s]), f"shard {s}")
    assert (plan.cap, plan.acap) == (fplan.cap, fplan.acap)
    a = engine.sample(tq, threefry.key(9), mesh=mesh)
    b = fresh.sample(tq, threefry.key(9), mesh=mesh)
    assert torch.equal(a.positions, b.positions) and int(a.count) == int(b.count)
    assert all(e["version"] == 2 for e in engine.cache_info()["shreds"])
    assert any(e["stacked"] for e in engine.cache_info()["shreds"])


# -- the cache, the edges ------------------------------------------------------

def test_sharded_warm_no_stacked_rebuild(dbs, queries):
    _, tdb = dbs
    _, tq = queries
    engine = port_engine(tdb)
    mesh = cpu_mesh()
    engine.sample(tq, threefry.key(0), mesh=mesh, axes=("data",))
    st0 = engine.stats.snapshot()
    assert st0.shred_builds == 1
    # new draws, the other entry points and a second mesh of the same shape
    engine.sample(tq, threefry.key(1), mesh=mesh, axes=("data",))
    engine.sample_batch(tq, threefry.keys(1, 3), mesh=mesh, axes=("data",))
    engine.full_join(tq, mesh=mesh, axes=("data",))
    engine.sample(tq, threefry.key(2), mesh=cpu_mesh(), axes=("data",))
    st1 = engine.stats
    assert st1.shred_builds == st0.shred_builds
    assert st1.plan_hits >= 3
    # the single-device path is another cache entry
    engine.sample(tq, threefry.key(3))
    assert engine.stats.shred_builds == st0.shred_builds + 1


def test_degenerate_meshes_fall_back_to_the_single_plan(dbs, queries):
    _, tdb = dbs
    _, tq = queries
    engine = port_engine(tdb)
    assert isinstance(engine.compile_sharded(tq, cpu_mesh(1)), CompiledPlan)
    model = cpu_mesh(axes=("model",))
    assert isinstance(engine.compile_sharded(tq, model), CompiledPlan)
    tight = TQueryEngine(tdb, device="cpu", kernel_policy=PREFER,
                         policy=CapacityPolicy(min_shard_rows=10**6))
    assert isinstance(tight.compile_sharded(tq, cpu_mesh()), CompiledPlan)
    a = engine.sample(tq, threefry.key(5), mesh=cpu_mesh(1))
    b = engine.sample(tq, threefry.key(5))
    assert torch.equal(a.positions, b.positions)
    with pytest.raises(ValueError, match="exprace"):
        engine.compile_sharded(tq, cpu_mesh(), method="ptbern_flat")


def test_sharded_empty_root():
    tab = {"R": {"x": np.zeros((0,), np.int64), "p": np.zeros((0,))},
           "S": {"x": np.array([1, 2]), "y": np.array([3, 4])}}
    _, tq = both_queries([("R", ("x", "p"), None), ("S", ("x", "y"), None)],
                         "p")
    engine = port_engine(TDatabase.from_columns(tab, device="cpu"))
    mesh = cpu_mesh()
    smp = engine.sample(tq, threefry.key(0), mesh=mesh, axes=("data",))
    assert int(smp.count) == 0 and not bool(smp.overflow)
    batch = engine.sample_batch(tq, threefry.keys(0, 3), mesh=mesh,
                                axes=("data",))
    assert batch.count.shape == (3,) and not batch.count.any()
    full = engine.full_join(tq, mesh=mesh, axes=("data",))
    assert set(full) == {"x", "p", "y"}
    assert all(len(v) == 0 for v in full.values())


def test_sharded_auto_redraw_overflow(dbs, queries):
    """A capacity of 1 overflows; auto mode redraws until no shard does."""
    _, tdb = dbs
    _, tq = queries
    engine = port_engine(tdb)
    mesh = cpu_mesh()
    s = engine.sample(tq, threefry.key(4), mesh=mesh, cap=1)
    assert bool(s.overflow) and int(s.count) <= 4
    s = engine.sample(tq, threefry.key(4), mesh=mesh, auto=True)
    assert not bool(s.overflow) and int(s.count) > 4


def test_mesh_entries():
    mesh = make_mesh((2, 3), ("data", "model"), devices="cpu")
    assert mesh.shape == {"data": 2, "model": 3} and mesh.size == 6
    assert mesh.shard_devices(("data",)) == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="no visible card"):
        make_mesh((2,), ("data",), devices=["cpu", "cuda:7"])
    with pytest.raises(ValueError, match="devices for a mesh"):
        make_mesh((3,), ("data",), devices=["cpu", "cpu"])
