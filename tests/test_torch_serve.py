"""The port's serving core against the JAX reference, on the CPU.

  * ``threefry.fold_in`` / ``fold_in_batch`` give ``jax.random.fold_in``'s
    key words exactly (integer work: no tolerance), 0 and 2^32 - 1 among
    the data; ``fold`` stays the in-kernel stream fold.
  * ``percentile`` / ``latency_summary`` equal the reference's.
  * The micro-batcher: the same stream (two shapes, interleaved updates)
    through the reference's ``serve_join_samples`` and the port's gives
    equal ``(count, overflow, db_version)`` and rows for every request,
    equal flush, dispatch and update counts. Under flat PTBERN (the
    reference pinned to its plain fused pipeline, ``kernels='reference'``)
    this is exact; under EXPRACE a request may differ only where an
    arrival lies within 4 float32 ulp of a cell boundary (``near_boundary``,
    tests/test_torch_kernels.py).
  * The reference's batcher tests, on the port: flush triggers, routing by
    fingerprint, the update barrier, zero rebuilds after an update.
  * ``serve.main`` in join mode on the CPU (an explicit device and
    policy), single-engine and fleet; ``--mode lm`` and ``--devices``
    refuse with a message; the default device is the card.
"""
import numpy as np
import pytest
import torch

import jax

from repro.core import Database
from repro.core.delta import DeltaBatch as RDeltaBatch
from repro.engine import QueryEngine
from repro.launch import metrics as r_metrics
from repro.launch.fleet import JoinSampleRequest as RRequest
from repro.launch.fleet import UpdateRequest as RUpdate
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.core import DeltaBatch
from repro_torch.engine import QueryEngine as TQueryEngine
from repro_torch.kernels import threefry
from repro_torch.launch import metrics, serve
from repro_torch.launch.fleet import (
    JoinSampleRequest, MicroBatcher, UpdateRequest, serve_join_samples,
)

from test_torch_kernels import _cells, near_boundary, ref_arrivals
from test_torch_shred import both_queries

PREFER = KernelPolicy(prefer=True)


# -- fold_in -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**40 + 7, -3])
def test_fold_in_matches_jax(seed):
    data = [0, 1, 5, 40, 80, 123456, 2**31, 2**32 - 1]
    key = jax.random.key(seed)
    want = np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(key, d))) for d in data]).astype(np.uint32)
    got = threefry.fold_in_batch(threefry.key(seed), data)
    assert got.dtype == np.uint32 and got.shape == (len(data), 2)
    np.testing.assert_array_equal(got, want)
    for d, w in zip(data, want):
        np.testing.assert_array_equal(threefry.fold_in(threefry.key(seed), d),
                                      w)


def test_fold_in_batch_equals_jitted_vmap_of_the_pipeline():
    """The reference pipeline's per-window keys: a vmap of fold_in over an
    arange of steps."""
    key = jax.random.key(7)
    steps = np.arange(32, 64)
    want = np.asarray(jax.random.key_data(jax.jit(jax.vmap(
        lambda s: jax.random.fold_in(key, s)))(steps)))
    np.testing.assert_array_equal(
        threefry.fold_in_batch(threefry.key(7), range(32, 64)),
        want.astype(np.uint32))


def test_fold_is_not_fold_in():
    """The two folds cipher (data, 0) and (0, data): both stay."""
    k = threefry.key(7)
    assert tuple(threefry.fold(k, 5)) == (202054026, 1137425630)
    assert tuple(int(w) for w in threefry.fold_in(k, 5)) == (3583082021,
                                                             1947592014)
    assert tuple(threefry.fold(k, 5)) == threefry.threefry2x32(7 >> 32, 7, 5, 0)
    assert tuple(int(w) for w in threefry.fold_in(k, 5)) == \
        threefry.threefry2x32(0, 7, 0, 5)


# -- metrics -------------------------------------------------------------------

@pytest.mark.parametrize("xs", [[1, 2, 3, 4], [5, 1, 3], [7.5],
                                list(range(1, 201)),
                                [15, 20, 35, 40, 50, 55, 60, 70, 80, 90]])
@pytest.mark.parametrize("q", [0.0, 0.3, 0.35, 0.5, 0.9, 0.99, 1.0])
def test_percentile_matches_reference(xs, q):
    assert metrics.percentile(xs, q) == r_metrics.percentile(xs, q)


@pytest.mark.parametrize("lat", [[], [0.001, 0.002, 0.004],
                                 list(np.linspace(1e-4, 3e-2, 57))])
def test_latency_summary_matches_reference(lat):
    assert metrics.latency_summary(lat) == r_metrics.latency_summary(lat)


def test_percentile_validation():
    with pytest.raises(ValueError, match="empty"):
        metrics.percentile([], 0.5)
    with pytest.raises(ValueError, match="q must be"):
        metrics.percentile([1.0], 1.5)


# -- the batcher against the reference ------------------------------------------

def tables():
    rng = np.random.default_rng(11)
    return {
        "R": {"x": rng.integers(0, 12, 90), "p": rng.random(90) * 0.5},
        "S": {"x": rng.integers(0, 12, 140), "y": rng.integers(0, 9, 140)},
        "T": {"y": rng.integers(0, 9, 60), "z": np.arange(60)},
    }


def shapes():
    """(reference, port) query pairs: R |><| S |><| T, R |><| S, R."""
    r3, t3 = both_queries([("R", ("x", "p"), None), ("S", ("x", "y"), None),
                           ("T", ("y", "z"), None)], "p")
    r2, t2 = both_queries([("R", ("x", "p"), None), ("S", ("x", "y"), None)],
                          "p")
    r1, t1 = both_queries([("R", ("x", "p"), None)], "p")
    return [(r3, t3), (r2, t2), (r1, t1)]


def delta_spec(i):
    return {"S": {"insert": {"x": [i % 12, (i + 3) % 12],
                             "y": [i % 9, (i + 1) % 9]},
                  "delete": [i % 5, 7]}}


class Pinned:
    """An engine whose batched draws all take one spec (the micro-batcher
    passes none): the reference's plain fused pipeline
    (``kernels='reference'``), or the port's method."""

    def __init__(self, engine, **kw):
        self.engine, self.kw = engine, kw

    @property
    def db(self):
        return self.engine.db

    @property
    def stats(self):
        return self.engine.stats

    def sample_batch(self, query, keys, mesh=None, axes=None):
        return self.engine.sample_batch(query, keys, **self.kw)

    def apply_delta(self, delta):
        self.engine.apply_delta(delta)
        return self


def streams(n=24, update_every=9):
    """The same stream for both packages: three shapes, an update after
    every ``update_every`` draws."""
    ref, port = [], []
    qs = shapes()
    for i in range(n):
        rq, tq = qs[i % 3]
        ref.append(RRequest(query=rq, seed=i))
        port.append(JoinSampleRequest(query=tq, seed=i))
        if i % update_every == update_every - 1:
            ref.append(RUpdate(RDeltaBatch.of(**delta_spec(i))))
            port.append(UpdateRequest(DeltaBatch.of(**delta_spec(i))))
    return ref, port


def engines(method):
    tab = tables()
    ref = QueryEngine(Database.from_columns(tab))
    port = TQueryEngine(TDatabase.from_columns(tab, device="cpu"),
                        device="cpu", kernel_policy=PREFER)
    return (Pinned(ref, method=method, kernels="reference"),
            Pinned(port, method=method))


def serve_both(method, max_batch, max_wait_ms=1e9):
    """The stream through both packages' batchers under one fake clock
    that advances 1 ms an arrival (``poll`` after each, as
    ``serve_join_samples`` does). Returns the engines, the completions in
    order and the batchers."""
    from repro.launch.fleet import MicroBatcher as RMicroBatcher

    ref, port = engines(method)
    rs, ts = streams()
    clock = FakeClock()
    out = []
    for cls, engine, stream in ((RMicroBatcher, ref, rs),
                                (MicroBatcher, port, ts)):
        clock.t = 0.0
        mb = cls(engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
                 clock=clock, collect_rows=True)
        done = []
        for r in stream:
            done += mb.submit(r)
            clock.t += 0.001
            done += mb.poll()
        done += mb.flush()
        out.append((engine, done, mb))
    (ref, rdone, rmb), (port, tdone, tmb) = out
    assert [type(r).__name__ for r in rdone] == \
        [type(r).__name__ for r in tdone]
    assert (rmb.flushes, rmb.dispatches, rmb.served, rmb.updates_applied) \
        == (tmb.flushes, tmb.dispatches, tmb.served, tmb.updates_applied)
    return ref, port, rdone, tdone


@pytest.mark.parametrize("max_batch,max_wait_ms", [(4, 1e9), (64, 2.5)])
def test_batcher_ptbern_equals_reference(max_batch, max_wait_ms):
    """Every request, the update barrier and the batcher's counters equal
    the reference's under flat PTBERN."""
    ref, port, rdone, tdone = serve_both("ptbern_flat", max_batch,
                                         max_wait_ms)
    draws = 0
    for a, b in zip(rdone, tdone):
        if isinstance(b, UpdateRequest):
            assert a.applied_version == b.applied_version
            continue
        draws += 1
        assert (a.seed, a.count, a.overflow, a.db_version, a.latency_s) == \
            (b.seed, b.count, b.overflow, b.db_version, b.latency_s)
        assert set(a.rows) == set(b.rows)
        for c in a.rows:
            np.testing.assert_array_equal(np.asarray(a.rows[c]), b.rows[c])
    assert draws == 24
    assert ref.db.version == port.db.version == 2
    rs, ts = ref.stats, port.stats
    for f in ("shred_builds", "plan_misses", "plan_hits", "shred_upgrades",
              "plan_upgrades"):
        assert getattr(rs, f) == getattr(ts, f), f


def test_batcher_exprace_equals_reference_up_to_boundaries():
    """The fused EXPRACE route: every request equal to the reference's,
    except one whose arrivals differ in cell only within 4 float32 ulp of
    a boundary."""
    ref, port, rdone, tdone = serve_both("exprace", 64, 2.5)
    exact = 0
    rplans, tplans = {}, {}
    for a, b in zip(rdone, tdone):
        if isinstance(b, UpdateRequest):
            continue
        same = (a.count, a.overflow, a.db_version) == \
            (b.count, b.overflow, b.db_version) and all(
                np.array_equal(np.asarray(a.rows[c]), b.rows[c])
                for c in a.rows)
        if same:
            exact += 1
            continue
        # a difference must come from an arrival at a cell boundary: replay
        # the draw's arrivals at its version under both packages
        key = (a.db_version, a.seed % 3)
        if key not in rplans:
            rplans[key], tplans[key] = plans_at(a.db_version, a.seed % 3)
        rplan, tplan = rplans[key], tplans[key]
        kd = threefry.key(a.seed)
        acap = rplan.arrival_capacity()
        v_ref, cells_ref = ref_arrivals(kd, rplan._dparams, acap)
        from repro_torch.kernels import fused_draw as t_fd
        v_port = t_fd.arrivals(kd, acap, "cpu").numpy()
        diff = np.nonzero(cells_ref != _cells(v_port, tplan.draw_params))[0]
        assert diff.size and near_boundary(v_ref, rplan._dparams, diff).all()
    assert exact >= 18


def plans_at(version, shape):
    """The reference's (pinned) and the port's plan of ``shape`` at the
    stream's snapshot ``version``."""
    tab = tables()
    rdb = Database.from_columns(tab)
    tdb = TDatabase.from_columns(tab, device="cpu")
    for i in range(24):
        if rdb.version == version:
            break
        if i % 9 == 8:
            rdb = rdb.apply(RDeltaBatch.of(**delta_spec(i)))
            tdb = tdb.apply(DeltaBatch.of(**delta_spec(i)))
    rq, tq = shapes()[shape]
    return (QueryEngine(rdb).compile(rq, kernels="reference"),
            TQueryEngine(tdb, device="cpu", kernel_policy=PREFER).compile(tq))


# -- the reference's batcher tests, on the port -----------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def port_db():
    return TDatabase.from_columns(tables(), device="cpu")


@pytest.fixture(scope="module")
def q3():
    return shapes()[0][1]


@pytest.fixture(scope="module")
def q2():
    return shapes()[1][1]


def port_engine(db):
    return TQueryEngine(db, device="cpu", kernel_policy=PREFER)


def test_flush_on_max_batch(port_db, q3):
    mb = MicroBatcher(port_engine(port_db), max_batch=4, max_wait_ms=1e9,
                      clock=FakeClock())
    for i in range(3):
        assert mb.submit(JoinSampleRequest(query=q3, seed=i)) == []
    assert len(mb.pending) == 3 and mb.flushes == 0
    done = mb.submit(JoinSampleRequest(query=q3, seed=3))
    assert len(done) == 4 and mb.pending == [] and mb.flushes == 1
    assert all(r.count is not None and r.latency_s is not None for r in done)
    assert mb.submit(JoinSampleRequest(query=q3, seed=4)) == []
    assert len(mb.pending) == 1


def test_flush_on_deadline(port_db, q3):
    clock = FakeClock()
    mb = MicroBatcher(port_engine(port_db), max_batch=100, max_wait_ms=5.0,
                      clock=clock)
    mb.submit(JoinSampleRequest(query=q3, seed=0))
    clock.t = 0.004
    assert mb.poll() == [] and len(mb.pending) == 1
    mb.submit(JoinSampleRequest(query=q3, seed=1))
    clock.t = 0.0051
    done = mb.poll()
    assert len(done) == 2 and mb.pending == [] and mb.flushes == 1
    assert done[0].latency_s == pytest.approx(0.0051)
    assert mb.poll() == []


@pytest.mark.parametrize("policy", [PREFER, None], ids=["fused", "pernode"])
def test_mixed_shapes_one_dispatch_each_and_exact_routing(port_db, q3, q2,
                                                          policy):
    engine = TQueryEngine(port_db, device="cpu", kernel_policy=policy)
    mb = MicroBatcher(engine, max_batch=8, max_wait_ms=1e9, clock=FakeClock())
    reqs = [JoinSampleRequest(query=q3 if i % 2 == 0 else q2, seed=10 + i)
            for i in range(8)]
    done = []
    for r in reqs:
        done += mb.submit(r)
    assert len(done) == 8 and mb.flushes == 1 and mb.dispatches == 2
    single = TQueryEngine(port_db, device="cpu", kernel_policy=policy)
    for r in reqs:
        want = single.sample(r.query, threefry.key(r.seed))
        assert r.count == int(want.count) and r.overflow == bool(want.overflow)
    assert engine.stats.plan_misses == 2 and engine.stats.shred_builds == 2
    st0 = engine.stats.snapshot()
    for i in range(8):
        mb.submit(JoinSampleRequest(query=q3 if i % 2 else q2, seed=50 + i))
    assert mb.flushes == 2
    assert engine.stats.plan_misses == st0.plan_misses
    assert engine.stats.shred_builds == st0.shred_builds
    assert engine.stats.plan_hits >= st0.plan_hits + 2


def test_collect_rows_equal_single_draws(port_db, q3):
    engine = port_engine(port_db)
    reqs = [JoinSampleRequest(query=q3, seed=s) for s in range(5)]
    serve_join_samples(engine, reqs, max_batch=8, collect_rows=True)
    for r in reqs:
        want = engine.sample(q3, threefry.key(r.seed))
        assert r.count == int(want.count)
        for c, col in want.columns.items():
            np.testing.assert_array_equal(r.rows[c],
                                          col[: r.count].numpy())


def test_serve_join_samples_drains_everything(port_db, q3, q2):
    reqs = [JoinSampleRequest(query=q3 if i % 3 else q2, seed=i)
            for i in range(11)]
    done = serve_join_samples(port_engine(port_db), reqs, max_batch=4)
    assert sorted(id(r) for r in done) == sorted(id(r) for r in reqs)
    assert all(r.count is not None for r in reqs)


def test_max_batch_validation_and_no_mesh(port_db):
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(port_engine(port_db), max_batch=0)
    with pytest.raises(NotImplementedError, match="A.5"):
        MicroBatcher(port_engine(port_db), mesh=object())
    with pytest.raises(NotImplementedError, match="A.5"):
        serve_join_samples(port_engine(port_db), [], mesh=object())


def _delta():
    return DeltaBatch.of(S={"insert": {"x": [3, 7], "y": [1, 2]},
                            "delete": [0, 1]})


def test_update_barrier_flushes_pending_draws_on_old_snapshot(port_db, q3):
    engine = port_engine(port_db)
    mb = MicroBatcher(engine, max_batch=100, max_wait_ms=1e9,
                      clock=FakeClock())
    before = [JoinSampleRequest(query=q3, seed=i) for i in range(3)]
    for r in before:
        mb.submit(r)
    done = mb.submit(UpdateRequest(_delta()))
    assert [id(x) for x in done[:3]] == [id(r) for r in before]
    assert all(r.db_version == 0 for r in before)
    assert isinstance(done[3], UpdateRequest)
    assert done[3].applied_version == 1 and engine.db.version == 1
    after = JoinSampleRequest(query=q3, seed=50)
    mb.submit(after)
    mb.flush()
    assert after.db_version == 1 and mb.updates_applied == 1


def test_update_between_flushes_zero_rebuilds(port_db, q3):
    engine = port_engine(port_db)
    mb = MicroBatcher(engine, max_batch=4, max_wait_ms=1e9, clock=FakeClock())
    for i in range(4):
        mb.submit(JoinSampleRequest(query=q3, seed=i))
    st0 = engine.stats.snapshot()
    mb.submit(UpdateRequest(_delta()))
    for i in range(4):
        mb.submit(JoinSampleRequest(query=q3, seed=10 + i))
    st1 = engine.stats
    assert st1.shred_builds == st0.shred_builds
    assert st1.plan_misses == st0.plan_misses
    assert st1.shred_upgrades >= 1 and st1.plan_upgrades >= 1


def test_update_results_match_engine_on_applied_snapshot(port_db, q3):
    engine = port_engine(port_db)
    mb = MicroBatcher(engine, max_batch=100, max_wait_ms=1e9,
                      clock=FakeClock())
    mb.submit(JoinSampleRequest(query=q3, seed=0))
    mb.submit(UpdateRequest(_delta()))
    reqs = [JoinSampleRequest(query=q3, seed=20 + i) for i in range(3)]
    for r in reqs:
        mb.submit(r)
    mb.flush()
    fresh = port_engine(port_db.apply(_delta()))
    for r in reqs:
        want = fresh.sample(q3, threefry.key(r.seed))
        assert r.count == int(want.count)
        assert r.overflow == bool(want.overflow)


def test_serve_join_samples_with_interleaved_updates(port_db, q3, q2):
    engine = port_engine(port_db)
    stream = []
    for i in range(9):
        stream.append(JoinSampleRequest(query=q3 if i % 2 else q2, seed=i))
        if i % 4 == 3:
            stream.append(UpdateRequest(_delta()))
    done = serve_join_samples(engine, stream, max_batch=4)
    assert sorted(id(r) for r in done) == sorted(id(r) for r in stream)
    draws = [r for r in stream if isinstance(r, JoinSampleRequest)]
    assert all(r.count is not None and r.db_version is not None
               for r in draws)
    assert engine.db.version == 2
    versions = [r.db_version for r in draws]
    assert versions == sorted(versions)


# -- the CLI ---------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--mode", "join", "--requests", "24", "--max-batch", "8"],
    ["--mode", "join", "--requests", "24", "--max-batch", "8",
     "--updates", "2", "--replicas", "3"],
], ids=["single", "fleet"])
def test_serve_main_join_on_cpu(argv, capsys):
    assert serve.main(argv + ["--device", "cpu"], kernel_policy=PREFER) == 0
    out = capsys.readouterr().out
    assert "draws/sec=" in out
    if "--replicas" in argv:
        assert "bit-identical to single-engine baseline: OK" in out


@pytest.mark.parametrize("argv,match", [
    (["--mode", "lm"], "A.7"),
    (["--mode", "join", "--devices", "2"], "A.5"),
])
def test_serve_main_refuses_unported_modes(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert e.value.code != 0
    assert match in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_serve_main_defaults_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--mode", "join", "--requests", "4"])


def test_serving_modules_load_no_jax():
    """The serving path and the data plane import torch and numpy only."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.launch.metrics\n"
            "import repro_torch.launch.fleet, repro_torch.data\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n"
            "print('NO_JAX_OK')\n")
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(src)))
    assert r.returncode == 0 and "NO_JAX_OK" in r.stdout, r.stdout + r.stderr
