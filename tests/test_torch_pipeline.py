"""The port's training-data pipeline against the JAX reference, on the CPU.

  * ``make_corpus_db`` / ``corpus_delta`` give the reference's databases:
    every column equal, dtypes included, after the deltas too.
  * ``PoissonJoinSource.batch_at(step)`` equals the reference's source
    under flat PTBERN (the reference pinned to its plain fused pipeline,
    ``kernels='reference'``; the port on its fused route) across delta
    barriers: tokens, targets, doc ids, ``sampled_k``, ``db_version``; the
    ``wrapped`` and ``overflows`` counters too.
  * The reference's pipeline contracts, on the port: resume mid-epoch,
    shuffled order, rewind refused, no window across a barrier, versions
    recorded, capacity rounding, the counted wrap; the per-step keys are
    ``fold_in`` of the step; ``Prefetcher`` yields the same batches.
"""
import time

import numpy as np
import pytest
import torch

from repro.core import Database
from repro.data import PoissonJoinSource as RSource
from repro.data import corpus_delta as r_corpus_delta
from repro.data import make_corpus_db as r_make_corpus_db
from repro.engine import DrawSpec as RDrawSpec
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.data import (
    PoissonJoinSource, Prefetcher, corpus_delta, make_corpus_db,
)
from repro_torch.engine import DrawSpec, QueryEngine
from repro_torch.kernels import threefry

SEQ, VOCAB = 13, 97
PREFER = KernelPolicy(prefer=True)


def _db():
    return make_corpus_db(96, 8, SEQ, VOCAB, seed=3, device="cpu")


def _source(db=None, batch=4, seed=7, deltas=(), window=4, **kw):
    db = db if db is not None else _db()
    kw.setdefault("kernel_policy", PREFER)
    return PoissonJoinSource(db, SEQ, batch, seed=seed, deltas=deltas,
                             window=window, **kw)


def _deltas(db, at=(6,), delta_fn=corpus_delta):
    """A schedule of live-corpus events, each built against the snapshot
    it applies to (insert + retire at every barrier)."""
    events, snap = [], db
    for i, s in enumerate(at):
        d = delta_fn(snap, SEQ, VOCAB, insert=16, retire=range(4),
                     seed=100 + i)
        events.append((s, d))
        snap = snap.apply(d)
    return tuple(events)


def _host(b):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in b.items()}


def _stream(src, steps, start=0):
    return [_host(src.batch_at(s)) for s in range(start, steps)]


def _assert_db_equal(port, ref):
    assert port.version == ref.version
    assert set(port.relations) == set(ref.relations)
    for name, rel in ref.relations.items():
        for col, v in rel.columns.items():
            got = port.relations[name].column(col).numpy()
            want = np.asarray(v)
            assert got.dtype == want.dtype, (name, col)
            np.testing.assert_array_equal(got, want)


# -- against the reference ----------------------------------------------------------

@pytest.mark.parametrize("args", [(96, 8, SEQ, VOCAB, 3),
                                  (500, 37, 5, 1000, 11)])
def test_corpus_and_deltas_equal_reference(args):
    ref = r_make_corpus_db(*args)
    port = make_corpus_db(*args, device="cpu")
    _assert_db_equal(port, ref)
    seq, vocab = args[2], args[3]
    for i, (ins, ret) in enumerate([(16, range(4)), (0, [1, 5, 9]),
                                    (7, ())]):
        rd = r_corpus_delta(ref, seq, vocab, insert=ins, retire=ret,
                            seed=100 + i)
        td = corpus_delta(port, seq, vocab, insert=ins, retire=ret,
                          seed=100 + i)
        ref, port = ref.apply(rd), port.apply(td)
        _assert_db_equal(port, ref)
    with pytest.raises(ValueError, match="nothing"):
        corpus_delta(port, seq, vocab)


@pytest.mark.parametrize("window,at", [(4, (6,)), (3, (3, 9))])
def test_batch_at_equals_reference_across_barriers(window, at):
    rdb = r_make_corpus_db(96, 8, SEQ, VOCAB, seed=3)
    tdb = _db()
    ref = RSource(rdb, SEQ, 4, seed=7, window=window,
                  deltas=_deltas(rdb, at, r_corpus_delta),
                  spec=RDrawSpec(method="ptbern_flat", kernels="reference"))
    port = _source(tdb, window=window, deltas=_deltas(tdb, at),
                   spec=DrawSpec(method="ptbern_flat"))
    assert port.engine.compile(port.query, port._spec).route == "fused"
    assert port.cap == ref.cap
    for step in range(12):
        a, b = ref.batch_at(step), _host(port.batch_at(step))
        assert int(a["db_version"]) == int(b["db_version"])
        assert int(a["sampled_k"]) == int(b["sampled_k"])
        for k in ("tokens", "targets", "doc_ids"):
            want = np.asarray(a[k])
            assert b[k].shape == want.shape, k
            np.testing.assert_array_equal(b[k], want, err_msg=k)
        assert b["tokens"].dtype == np.int32
    assert (port.wrapped, port.overflows) == (ref.wrapped, ref.overflows)


def test_wrap_counters_equal_reference():
    """A corpus the draw can never fill: both count every batch."""
    cols = {
        "Doc": {"doc": np.arange(6), "clust": np.zeros(6, np.int64)},
        "ClusterQuality": {"clust": np.array([0]), "p": np.array([0.4])},
        "_tokens": {"flat":
                    np.random.default_rng(0).integers(0, VOCAB, 6 * SEQ)},
    }
    spec = dict(method="ptbern_flat")
    ref = RSource(Database.from_columns(cols), SEQ, 16, seed=11, window=2,
                  spec=RDrawSpec(kernels="reference", **spec))
    port = PoissonJoinSource(TDatabase.from_columns(cols, device="cpu"), SEQ,
                             16, seed=11, window=2, spec=DrawSpec(**spec),
                             kernel_policy=PREFER)
    for step in range(6):
        a, b = ref.batch_at(step), _host(port.batch_at(step))
        assert int(a["sampled_k"]) == int(b["sampled_k"])
        np.testing.assert_array_equal(b["doc_ids"], np.asarray(a["doc_ids"]))
    assert port.wrapped == ref.wrapped == 6
    assert port.overflows == ref.overflows == 0


# -- the reference's pipeline contracts, on the port -------------------------------

def test_per_step_keys_are_fold_in_of_the_step():
    src = _source()
    b = src.batch_at(5)
    key = threefry.fold_in(threefry.key(7), 5)
    smp = src.engine.sample(src.query, key, src._spec)
    k = int(smp.count)
    docs = smp.columns["doc"][np.arange(4) % max(k, 1)]
    assert int(b["sampled_k"]) == k
    assert torch.equal(b["doc_ids"], docs)


@pytest.mark.parametrize("route", ["fused", "pernode"])
def test_resume_mid_epoch_bit_identical(route):
    db = _db()
    deltas = _deltas(db, at=(3, 9))
    kw = {} if route == "fused" else {"kernel_policy": None}
    full = _stream(_source(db, deltas=deltas, **kw), 12)
    resumed = _stream(_source(db, deltas=deltas, **kw), 12, start=5)
    for a, b in zip(full[5:], resumed):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_shuffled_order_equals_in_order():
    """Each batch is a pure function of its step: a fresh source taking
    the steps of each snapshot in any order (the snapshots in order) gives
    the same batches. Without the eager dispatch (``depth=1``): at depth 2
    the window before a barrier dispatches the next one, which applies the
    delta, and an earlier step of the old snapshot is then a rewind."""
    db = _db()
    deltas = _deltas(db, at=(8,))
    full = _stream(_source(db, deltas=deltas), 16)
    src = _source(db, deltas=deltas, depth=1)
    rng = np.random.default_rng(5)
    for lo, hi in ((0, 8), (8, 16)):  # the engine only moves forward
        for step in rng.permutation(np.arange(lo, hi)):
            b = _host(src.batch_at(int(step)))
            for k in b:
                np.testing.assert_array_equal(b[k], full[step][k])


def test_rewind_requires_fresh_source():
    db = _db()
    src = _source(db, deltas=_deltas(db, at=(4,)))
    src.batch_at(6)
    with pytest.raises(ValueError, match="fresh source"):
        src.batch_at(2)


def test_no_window_straddles_a_barrier():
    db = _db()
    deltas = _deltas(db, at=(5, 9))
    src = _source(db, deltas=deltas)
    for step in range(16):
        s0, end = src._window_bounds(step)
        assert s0 <= step < end
        for e, _ in deltas:
            assert not (s0 < e < end)
        assert _source(db, deltas=deltas)._window_bounds(step) == (s0, end)


def test_batches_record_their_snapshot_version():
    db = _db()
    src = _source(db, deltas=_deltas(db, at=(5, 9)))
    got = [int(b["db_version"]) for b in _stream(src, 12)]
    assert got == [src.version_at(s) for s in range(12)]
    assert got == [0] * 5 + [1] * 4 + [2] * 3


def test_pre_barrier_batches_unaffected_by_schedule():
    db = _db()
    plain = _stream(_source(db), 6)
    live = _stream(_source(db, deltas=_deltas(db, at=(6,))), 6)
    for a, b in zip(plain, live):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["doc_ids"], b["doc_ids"])


def test_capacity_rounds_to_lane_multiple_and_covers_batch():
    src = _source(batch=200)
    assert src.cap % 128 == 0 and src.cap >= 200


def test_wrapped_counter_stays_zero_when_draws_fill_batch():
    src = _source(batch=2)
    for step in range(4):
        src.batch_at(step)
    assert src.wrapped == 0


def test_source_builds_its_engine_on_the_database_device():
    src = _source()
    assert src.engine.device == torch.device("cpu")
    assert src.engine.kernel_policy is PREFER
    engine = QueryEngine(_db(), device="cpu")
    assert PoissonJoinSource(None, SEQ, 4, engine=engine).engine is engine
    with pytest.raises(ValueError, match="Database or a QueryEngine"):
        PoissonJoinSource(None, SEQ, 4)
    with pytest.raises(ValueError, match="window"):
        _source(window=0)


def test_prefetcher_yields_the_same_batches():
    db = _db()
    deltas = _deltas(db, at=(5,))
    full = _stream(_source(db, deltas=deltas), 10)
    pf = Prefetcher(_source(db, deltas=deltas), start_step=2, depth=2)
    try:
        for want_step in range(2, 10):
            step, b = next(pf)
            assert step == want_step
            b = _host(b)
            for k in b:
                np.testing.assert_array_equal(b[k], full[step][k])
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


def test_prefetcher_draws_each_step_once_when_the_queue_is_full():
    class Counting:
        def __init__(self):
            self.calls = []

        def batch_at(self, step):
            self.calls.append(step)
            return step

    src = Counting()
    pf = Prefetcher(src, start_step=0, depth=1)
    try:
        time.sleep(1.2)  # the full queue times out a put twice meanwhile
        assert [next(pf) for _ in range(3)] == [(0, 0), (1, 1), (2, 2)]
    finally:
        pf.stop()
    assert len(src.calls) == len(set(src.calls)), src.calls
