"""The port's replicated fleet against the JAX reference, on the CPU, under
the simulated clock.

  * Routing: the home replica of every query shape (md5 of the query
    fingerprint) equals the reference's, over many shapes and fleet sizes.
  * Faults: the same fault plan (a crash mid-flush, a dropped response, a
    delayed request, a crash at a catch-up apply, admission overflow and
    resubmission) over the same stream gives the reference's outcomes:
    the completions in order with their versions and sim-time latencies,
    which replica served which request id at which version, the router's
    counters (accepted, rejected, retries, duplicates, updates), each
    replica's state, stale serves, duplicates, flushes and dispatches,
    its snapshots, the transport's deliveries and drops, the aggregated
    cache stats and the log. None of these depends on the drawn values.
  * Values: every port draw equals the port's own single engine (or its
    single-engine micro-batcher, rows included) at the stamped version;
    the replicas' snapshots equal the log applied in order. The reference
    draws per node through ``jax.random`` here, so values are compared
    with the port itself; tests/test_torch_serve.py holds the batcher's
    values against the reference's.
"""
import hashlib
import types

import numpy as np
import pytest

from repro.core import Database
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.engine import CacheStats, QueryEngine, query_fingerprint
from repro_torch.kernels import threefry
from repro_torch.launch import fleet as T
from repro_torch.launch.fleet import (
    CRASH, DOWN, DROP, FaultInjector, Fleet, JoinSampleRequest, Rejected,
    UpdateRequest, serve_fleet, serve_join_samples,
)

from test_torch_shred import both_queries

PREFER = KernelPolicy(prefer=True)
STATS = ("shred_builds", "shred_hits", "plan_hits", "plan_misses",
         "shred_upgrades", "plan_upgrades")


def tables():
    rng = np.random.default_rng(3)
    return {
        "R": {"x": rng.integers(0, 10, 70), "p": rng.random(70) * 0.5},
        "S": {"x": rng.integers(0, 10, 110), "y": rng.integers(0, 8, 110)},
        "T": {"y": rng.integers(0, 8, 40), "z": np.arange(40)},
    }


def query_pairs():
    """(reference, port) pairs: R, R |><| S, R |><| S |><| T."""
    atoms = [("R", ("x", "p"), None), ("S", ("x", "y"), None),
             ("T", ("y", "z"), None)]
    return [both_queries(atoms[:n], "p") for n in (1, 2, 3)]


def package(which):
    """Everything a scenario needs from one package, on the CPU."""
    pairs = query_pairs()
    if which == "ref":
        from repro.core.delta import DeltaBatch
        from repro.engine import query_fingerprint as fp
        from repro.launch import fleet

        return types.SimpleNamespace(
            F=fleet, DeltaBatch=DeltaBatch, fp=fp, kw={},
            db=Database.from_columns(tables()), qs=[p[0] for p in pairs])
    from repro_torch.core import DeltaBatch

    return types.SimpleNamespace(
        F=T, DeltaBatch=DeltaBatch, fp=query_fingerprint,
        kw={"kernel_policy": PREFER},
        db=TDatabase.from_columns(tables(), device="cpu"),
        qs=[p[1] for p in pairs])


def delta(p, i=0):
    return p.DeltaBatch.of(S={"insert": {"x": [i % 10, (i + 3) % 10],
                                         "y": [i % 8, (i + 1) % 8]},
                              "delete": [0]})


def summary(fleet, done):
    """What a fleet run did, independent of the drawn values."""
    rt = fleet.router

    def item(r):
        if type(r).__name__ == "Rejected":
            return ("rejected", r.request.seed, r.reason)
        if type(r).__name__ == "UpdateRequest":
            return ("update", r.applied_version, r.latency_s)
        return ("draw", r.seed, r.db_version, r.latency_s)

    stats = fleet.stats()
    return {
        "done": [item(r) for r in done],
        "served": sorted((rid, rep.name, resp.db_version)
                         for rep in fleet.replicas
                         for rid, resp in rep.served.items()),
        "router": (rt.accepted, rt.rejected, rt.retries, rt.duplicates,
                   rt.updates, sorted(rt.drained), dict(rt.health)),
        "replicas": [(r.name, r.state, r.stale_serves, r.duplicates,
                      r.batcher.flushes, r.batcher.dispatches,
                      sorted(r.snapshots)) for r in fleet.replicas],
        "transport": (fleet.transport.delivered, fleet.transport.dropped,
                      fleet.transport.faults.pending),
        "stats": tuple(getattr(stats, f) for f in STATS),
        "log": (fleet.log.head, fleet.db_version),
    }


# -- scenarios: each runs on either package ----------------------------------------

def crash_mid_flush(p):
    faults = p.F.FaultInjector()
    fleet = p.F.Fleet(p.db, replicas=3, max_batch=4, max_wait_ms=1e9,
                      faults=faults, retry_timeout_s=0.05, **p.kw)
    home = fleet.router._route(p.fp(p.qs[1]))
    faults.inject(f"{home}:flush", p.F.CRASH, at=2)
    for i in range(12):
        assert fleet.submit(p.F.JoinSampleRequest(query=p.qs[1], seed=i)) \
            is None
    return fleet, fleet.drain()


def crash_during_catchup_apply(p):
    faults = p.F.FaultInjector()
    fleet = p.F.Fleet(p.db, replicas=2, max_batch=100, max_wait_ms=1e9,
                      faults=faults, retry_timeout_s=0.05, **p.kw)
    home = fleet.router._route(p.fp(p.qs[1]))
    faults.inject(f"{home}:apply", p.F.CRASH)
    fleet.submit(p.F.UpdateRequest(delta(p)))
    fleet.submit(p.F.JoinSampleRequest(query=p.qs[1], seed=5))
    return fleet, fleet.drain()


def delayed_stale_serve(p):
    faults = p.F.FaultInjector()
    fleet = p.F.Fleet(p.db, replicas=2, max_batch=1, max_wait_ms=1e9,
                      faults=faults, retry_timeout_s=10.0, **p.kw)
    home = fleet.router._route(p.fp(p.qs[1]))
    faults.inject(f"deliver:router->{home}", ("delay", 0.010))
    fleet.submit(p.F.JoinSampleRequest(query=p.qs[1], seed=1))
    fleet.submit(p.F.UpdateRequest(delta(p)))
    fleet.submit(p.F.JoinSampleRequest(query=p.qs[1], seed=2))
    done = fleet.take_completed() + fleet.advance(0.02)
    return fleet, done + fleet.drain()


def dropped_messages(p):
    """The first request to the home replica drops, then the first
    response from it: one plain retry, one idempotent duplicate."""
    faults = p.F.FaultInjector()
    fleet = p.F.Fleet(p.db, replicas=2, max_batch=1, max_wait_ms=1e9,
                      faults=faults, retry_timeout_s=0.05, **p.kw)
    home = fleet.router._route(p.fp(p.qs[1]))
    faults.inject(f"deliver:router->{home}", p.F.DROP)
    faults.inject(f"deliver:{home}->router", p.F.DROP)
    done = []
    for seed in (3, 4):
        fleet.submit(p.F.JoinSampleRequest(query=p.qs[1], seed=seed))
        done += fleet.take_completed() + fleet.advance(0.06)
    return fleet, done + fleet.drain()


def mixed_faults(p):
    faults = p.F.FaultInjector()
    fleet = p.F.Fleet(p.db, replicas=3, max_batch=3, max_wait_ms=1e9,
                      faults=faults, retry_timeout_s=0.05, **p.kw)
    home = fleet.router._route(p.fp(p.qs[1]))
    names = [r.name for r in fleet.replicas]
    successor = names[(names.index(home) + 1) % 3]
    faults.inject(f"deliver:router->{home}", ("delay", 0.005), at=2)
    faults.inject(f"{home}:flush", p.F.CRASH, at=3)
    faults.inject(f"deliver:{successor}->router", p.F.DROP, at=1)
    done = []
    for i in range(18):
        if i % 6 == 5:
            fleet.submit(p.F.UpdateRequest(delta(p, i)))
        else:
            res = fleet.submit(p.F.JoinSampleRequest(query=p.qs[1],
                                                     seed=100 + i))
            assert res is None
        done += fleet.advance(0.001)
    done += fleet.advance(0.1)
    return fleet, done + fleet.drain()


def admission(p):
    """A full window rejects (explicitly); a deadline flush clears it and
    the rejected request is admitted on resubmission; a drained fleet
    rejects."""
    fleet = p.F.Fleet(p.db, replicas=2, max_batch=100, max_wait_ms=5.0,
                      max_inflight=4, **p.kw)
    done, rejected = [], []
    for i in range(7):
        req = p.F.JoinSampleRequest(query=p.qs[0], seed=i)
        res = fleet.submit(req)
        if res is not None:
            done.append(res)
            rejected.append(req)
    done += fleet.advance(0.006)
    for req in rejected:
        assert fleet.submit(req) is None
    done += fleet.drain()
    done.append(fleet.submit(p.F.JoinSampleRequest(query=p.qs[0], seed=99)))
    return fleet, done


SCENARIOS = [crash_mid_flush, crash_during_catchup_apply, delayed_stale_serve,
             dropped_messages, mixed_faults, admission]


def snapshots(tdb, fleet):
    """The port's snapshot history: the log applied in order."""
    dbs = [tdb]
    for lsn in range(1, fleet.log.head + 1):
        dbs.append(dbs[-1].apply(fleet.log.entry(lsn)))
    return dbs


def assert_draws_equal_single_engine(tdb, fleet, done, q=None):
    """Each port draw equals a fresh port engine's single draw at its
    stamped version (one engine a version)."""
    dbs = snapshots(tdb, fleet)
    engines = {}
    draws = [r for r in done if isinstance(r, JoinSampleRequest)]
    for r in draws:
        eng = engines.setdefault(r.db_version, QueryEngine(
            dbs[r.db_version], device="cpu", kernel_policy=PREFER))
        want = eng.sample(q or r.query, threefry.key(r.seed))
        assert (r.count, r.overflow) == (int(want.count),
                                         bool(want.overflow)), r.seed
    return draws


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_fault_outcomes_equal_reference(scenario):
    ref, port = package("ref"), package("port")
    rfleet, rdone = scenario(ref)
    tfleet, tdone = scenario(port)
    rs, ts = summary(rfleet, rdone), summary(tfleet, tdone)
    for k in rs:
        assert rs[k] == ts[k], k
    draws = assert_draws_equal_single_engine(port.db, tfleet, tdone)
    assert len({id(r) for r in draws}) == len(draws)  # nothing served twice
    assert tfleet.transport.faults.pending == 0


@pytest.mark.parametrize("replicas", [1, 2, 3, 4, 7])
def test_router_choice_equals_reference(replicas):
    """The home replica of 60 shapes (atoms, aliases, prob_var varied)."""
    from repro.launch.fleet import Fleet as RFleet

    rfleet = RFleet(Database.from_columns(tables()), replicas=replicas)
    tfleet = Fleet(TDatabase.from_columns(tables(), device="cpu"),
                   replicas=replicas, kernel_policy=PREFER)
    names = "RST"
    for i in range(60):
        atoms = [(names[(i + j) % 3], ("x", "p") if (i + j) % 3 == 0 else
                  ("x", "y") if (i + j) % 3 == 1 else ("y", "z"),
                  f"a{j}" if i % 4 == 0 else None) for j in range(1 + i % 3)]
        has_p = any(a[0] == "R" for a in atoms)
        rq, tq = both_queries(atoms, "p" if has_p and i % 2 else None)
        from repro.engine import query_fingerprint as r_fp
        assert r_fp(rq) == query_fingerprint(tq)
        assert rfleet.router._route(r_fp(rq)) == \
            tfleet.router._route(query_fingerprint(tq))


# -- the reference's fleet tests, on the port ------------------------------------------

def home_of(fleet, q):
    """The shape's home replica (the router's hash; no health check, so it
    holds after a drain)."""
    n = len(fleet.replicas)
    digest = hashlib.md5(query_fingerprint(q).encode()).hexdigest()
    return fleet.replicas[int(digest, 16) % n].name


@pytest.fixture(scope="module")
def port():
    return package("port")


def test_crash_mid_flush_retries_on_healthy_replica(port):
    fleet, done = crash_mid_flush(port)
    assert fleet.transport.faults.pending == 0
    home = home_of(fleet, port.qs[1])
    assert fleet.router.health[home] == DOWN and fleet.router.retries >= 4
    draws = assert_draws_equal_single_engine(port.db, fleet, done)
    assert len(draws) == 12 and all(r.db_version == 0 for r in draws)


def test_delayed_draw_is_served_stale_from_its_snapshot(port):
    fleet, done = delayed_stale_serve(port)
    old, new = sorted((r for r in done if isinstance(r, JoinSampleRequest)),
                      key=lambda r: r.seed)
    assert new.db_version == 1 and old.db_version == 0
    home = home_of(fleet, port.qs[1])
    assert next(r for r in fleet.replicas if r.name == home).stale_serves == 1
    assert_draws_equal_single_engine(port.db, fleet, done)


def test_dropped_response_is_answered_from_the_served_cache(port):
    fleet, done = dropped_messages(port)
    home = home_of(fleet, port.qs[1])
    rep = next(r for r in fleet.replicas if r.name == home)
    assert rep.duplicates == 1 and fleet.router.retries == 2
    assert len([r for r in done if isinstance(r, JoinSampleRequest)]) == 2


def test_affinity_one_plan_miss_per_shape(port):
    fleet = Fleet(port.db, replicas=3, max_batch=4, max_wait_ms=1e9,
                  kernel_policy=PREFER)
    for i in range(24):
        assert fleet.submit(JoinSampleRequest(query=port.qs[i % 3],
                                              seed=i)) is None
    assert len(fleet.drain()) == 24
    agg = fleet.stats()
    assert agg.plan_misses == 3 and agg.shred_builds == 3
    assert agg == CacheStats.aggregate(r.engine.stats for r in fleet.replicas)


def test_deadline_flush_is_clock_driven_and_reproducible(port):
    def run():
        fleet = Fleet(port.db, replicas=2, max_batch=100, max_wait_ms=5.0,
                      kernel_policy=PREFER)
        req = JoinSampleRequest(query=port.qs[1], seed=9)
        fleet.submit(req)
        assert fleet.advance(0.004) == []
        assert [id(r) for r in fleet.advance(0.002)] == [id(req)]
        return req.latency_s
    assert run() == run() == pytest.approx(0.005)


def test_drained_fleet_rejects_new_work(port):
    fleet = Fleet(port.db, replicas=2, kernel_policy=PREFER)
    fleet.submit(JoinSampleRequest(query=port.qs[0], seed=0))
    fleet.drain()
    res = fleet.submit(JoinSampleRequest(query=port.qs[0], seed=1))
    assert isinstance(res, Rejected) and "no healthy replicas" in res.reason
    assert all(h == DOWN for h in fleet.health().values())


def test_update_commits_at_log_append(port):
    fleet = Fleet(port.db, replicas=2, max_batch=100, max_wait_ms=1e9,
                  kernel_policy=PREFER)
    before = JoinSampleRequest(query=port.qs[1], seed=0)
    fleet.submit(before)
    upd = UpdateRequest(delta(port))
    assert fleet.submit(upd) is None
    assert upd.applied_version == 1 and fleet.log.entry(1).lsn == 1
    after = JoinSampleRequest(query=port.qs[1], seed=1)
    fleet.submit(after)
    done = fleet.drain()
    assert before.db_version == 0 and after.db_version == 1
    assert_draws_equal_single_engine(port.db, fleet, done)


def test_replica_engines_take_the_fleet_policy_and_device(port):
    fleet = Fleet(port.db, replicas=2, kernel_policy=PREFER)
    for r in fleet.replicas:
        assert r.engine.kernel_policy is PREFER
        assert r.engine.device == port.db.device


def _stream(port, ops):
    """ops -> a request stream; op 0 is an update, 1 and 2 pick a shape."""
    out = []
    for i, op in enumerate(ops):
        if op == 0:
            out.append(UpdateRequest(delta(port, i)))
        else:
            out.append(JoinSampleRequest(query=port.qs[op], seed=100 + i))
    return out


def _assert_db_equal(got, want):
    assert got.version == want.version
    assert set(got.relations) == set(want.relations)
    for name, rel in want.relations.items():
        for col, v in rel.columns.items():
            w = got.relations[name].column(col)
            assert w.dtype == v.dtype and np.array_equal(w.numpy(), v.numpy())


@pytest.mark.parametrize("n_replicas,ops,max_batch,delays", [
    (3, [1, 2, 0, 1, 2, 1, 0, 2, 1], 3, [(0, 1, 0.015), (1, 2, 0.003)]),
    (2, [2, 0, 2, 2], 1, [(0, 1, 0.003)]),
    (4, [1, 1, 0, 0, 2, 1, 2, 0, 1, 2, 2, 1], 100,
     [(1, 1, 0.015), (2, 3, 0.003), (3, 2, 0.015)]),
    (2, [0, 1, 2, 0, 1, 2, 0, 1], 3, []),
])
def test_interleavings_bit_identical_to_single_engine(port, n_replicas, ops,
                                                      max_batch, delays):
    """Replicas' snapshots equal the log applied in order; every draw's
    (count, overflow, rows) equals the single-engine micro-batcher's at
    its stamped version."""
    ops = ops + [1, 2]
    faults = FaultInjector()
    fleet = Fleet(port.db, replicas=n_replicas, max_batch=max_batch,
                  max_wait_ms=1e9, max_inflight=1024, faults=faults,
                  collect_rows=True, kernel_policy=PREFER)
    for ridx, at, delay in delays:
        name = fleet.replicas[ridx % n_replicas].name
        faults.inject(f"deliver:router->{name}", ("delay", delay), at=at)
    reqs = _stream(port, ops)
    done = []
    for r in reqs:
        assert fleet.submit(r) is None
        done += fleet.advance(0.001)
    done += fleet.advance(0.05) + fleet.drain()
    draws = [r for r in done if isinstance(r, JoinSampleRequest)]
    assert {id(r) for r in draws} == {
        id(r) for r in reqs if isinstance(r, JoinSampleRequest)}
    dbs = snapshots(port.db, fleet)
    for rep in fleet.replicas:
        if rep.name in fleet.router.drained:
            _assert_db_equal(rep.engine.db, dbs[-1])
        for version, snap in rep.snapshots.items():
            _assert_db_equal(snap, dbs[version])
    engine = QueryEngine(port.db, device="cpu", kernel_policy=PREFER)
    base = {(r.seed, r.db_version): r
            for r in serve_join_samples(engine, _stream(port, ops),
                                        max_batch=max_batch,
                                        collect_rows=True)
            if isinstance(r, JoinSampleRequest)}
    for r in draws:
        want = base[(r.seed, r.db_version)]
        assert (r.count, r.overflow) == (want.count, want.overflow)
        assert set(r.rows) == set(want.rows)
        for c in want.rows:
            np.testing.assert_array_equal(r.rows[c], want.rows[c])


def test_serve_fleet_real_clock_with_a_crash_equals_baseline(port):
    """The demo's path: a real clock, one replica crashed mid-stream."""
    def stream():
        s = []
        for i in range(20):
            s.append(JoinSampleRequest(query=port.qs[i % 3], seed=i))
            if i % 6 == 5:
                s.append(UpdateRequest(port.DeltaBatch.of(
                    S={"insert": {"x": [i % 10], "y": [i % 8]}})))
        return s

    done, fleet = serve_fleet(port.db, stream(), replicas=3, max_batch=4,
                              clock="real", retry_timeout_s=30.0,
                              crash_at=10, crash_replica=2,
                              collect_rows=True, kernel_policy=PREFER)
    draws = [r for r in done if isinstance(r, JoinSampleRequest)]
    assert len(draws) == 20 and len({id(r) for r in draws}) == 20
    assert fleet.replicas[2].state == DOWN
    engine = QueryEngine(port.db, device="cpu", kernel_policy=PREFER)
    base = {(r.seed, r.db_version): r
            for r in serve_join_samples(engine, stream(), max_batch=4,
                                        collect_rows=True)
            if isinstance(r, JoinSampleRequest)}
    for r in draws:
        b = base[(r.seed, r.db_version)]
        assert (r.count, r.overflow) == (b.count, b.overflow)
        for c in b.rows:
            assert np.array_equal(r.rows[c], b.rows[c])


def test_fault_injector_validates_actions():
    faults = FaultInjector()
    with pytest.raises(ValueError):
        faults.inject("x", "explode")
    with pytest.raises(ValueError):
        faults.inject("x", ("delay", -1.0))
    faults.inject("x", CRASH, at=2).inject("y", DROP)
    assert faults.fire("x") is None and faults.fire("x") == CRASH
    assert faults.pending == 1
