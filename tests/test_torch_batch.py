"""Batched draws of the PyTorch port against the JAX reference, on the CPU.

  * ``threefry.split`` gives ``jax.random.split``'s key words exactly
    (integer work: no tolerance), and ``threefry.keys(seed, B)`` those of
    ``split(key(seed), B)``.
  * ``bucket_size`` and ``pad_batch_keys`` bucket a batch as the
    reference does.
  * ``sample_batch`` lane b equals ``sample(keys[b])`` on every route
    (fused, paged, per-node with and without the int32 searches), for a
    padded batch (6) and a full bucket (8), with both methods.
  * The fused batch against the reference's ``sample_batch(...,
    kernels='reference')`` under one split key: positions, counts and rows
    equal except where an arrival lies within 4 float32 ulp of a cell
    boundary (``near_boundary``; the arrival sum is ordered differently);
    flat PTBERN exactly.
  * The cache contract: single and batched draws share one plan, warm
    same-bucket batches rebuild nothing; the empty join and a query
    without ``prob_var``.
  * The batched kernels' wrappers on a fake library: one launch a batch,
    the keys handed over as a (B, 2) device array, the outputs' shapes.

On the card ``chip_smoke.py`` (phase E) holds the batched kernel against
its plain version and every lane against a single draw.
"""
import numpy as np
import pytest
import torch

import jax

from repro.engine.executors import bucket_size as r_bucket_size
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.engine import QueryEngine as TQueryEngine
from repro_torch.engine.executors import bucket_size, pad_batch_keys
from repro_torch.kernels import fused_draw as t_fd
from repro_torch.kernels import threefry as t_threefry

from test_torch_engine import PREFER, engines
from test_torch_kernels import _cells, near_boundary, ref_arrivals, star_chain
from test_torch_shred import both_queries


@pytest.mark.parametrize("num", [1, 2, 5, 8, 64])
@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**40 + 7, -3])
def test_split_matches_jax(seed, num):
    key = jax.random.key(seed)
    want = np.asarray(jax.random.key_data(jax.random.split(key, num)))
    got = t_threefry.split(t_threefry.key(seed), num)
    assert got.dtype == np.uint32 and got.shape == (num, 2)
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    np.testing.assert_array_equal(t_threefry.keys(seed, num), got)


def test_split_of_a_split_key_matches_jax():
    parent = jax.random.split(jax.random.key(11), 3)[2]
    want = np.asarray(jax.random.key_data(jax.random.split(parent, 4)))
    got = t_threefry.split(np.asarray(jax.random.key_data(parent)), 4)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_bucket_size():
    sizes = (1, 2, 3, 4, 5, 8, 9, 64, 65)
    assert [bucket_size(b) for b in sizes] == [r_bucket_size(b) for b in sizes]
    with pytest.raises(ValueError):
        bucket_size(0)


def test_pad_batch_keys_pads_to_bucket():
    keys = t_threefry.keys(0, 6)
    padded, b = pad_batch_keys(keys)
    assert b == 6 and padded.shape == (8, 2) and padded.dtype == np.uint32
    np.testing.assert_array_equal(padded[:6], keys)
    np.testing.assert_array_equal(padded[6], keys[5])
    np.testing.assert_array_equal(padded[7], keys[5])
    full, b = pad_batch_keys(t_threefry.keys(0, 8))
    assert b == 8 and full.shape == (8, 2)
    # a tensor of the words pads the same way
    padded_t, _ = pad_batch_keys(torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_array_equal(padded_t, padded)


def _route_engine(route):
    """The port's engine on star_chain(0) and the draw kwargs that take
    ``route``: fused and paged under a preferring policy (paged with the
    draw and arena budgets just under the arena), per-node by default and
    with the int32 searches."""
    tables, q = star_chain(0)
    _, port, tq = engines(tables, q, PREFER)
    if route == "paged":
        size = port.compile(tq).shred.packed.layout.size
        port = TQueryEngine(port.db, device="cpu", kernel_policy=KernelPolicy(
            prefer=True, arena_limit=size - 1, draw_limit=size - 1))
    if route == "pernode":
        port = TQueryEngine(port.db, device="cpu")
    kw = {"kernels": "pernode"} if route == "pernode-narrow" else {}
    return port, tq, kw


def assert_lane_equal(batched, single, b):
    assert int(batched.count[b]) == int(single.count)
    assert bool(batched.overflow[b]) == bool(single.overflow)
    assert torch.equal(batched.positions[b], single.positions)
    assert set(batched.columns) == set(single.columns)
    for v, col in single.columns.items():
        assert torch.equal(batched.columns[v][b], col), v


@pytest.mark.parametrize("B", [6, 8])
@pytest.mark.parametrize("method", ["exprace", "ptbern_flat"])
@pytest.mark.parametrize("route", ["fused", "paged", "pernode",
                                   "pernode-narrow"])
def test_sample_batch_lanes_equal_single_draws(route, method, B):
    port, tq, kw = _route_engine(route)
    plan = port.compile(tq, method=method, **kw)
    assert plan.route == route.split("-")[0]
    keys = t_threefry.keys(3, B)
    batched = port.sample_batch(tq, keys, method=method, **kw)
    assert batched.batch == B and batched.positions.shape == (B, batched.capacity)
    assert batched.valid().shape == batched.positions.shape
    assert torch.equal(batched.valid().sum(1), batched.count)
    for b in range(B):
        assert_lane_equal(batched, port.sample(tq, keys[b], method=method,
                                               **kw), b)


def test_explicit_rep_pins_the_pernode_route():
    port, tq, _ = _route_engine("fused")
    keys = t_threefry.keys(5, 3)
    batched = port.sample_batch(tq, keys, rep="usr")
    for b in range(3):
        assert_lane_equal(batched, port.sample(tq, keys[b], rep="usr"), b)
    fused = port.sample_batch(tq, keys)
    assert not torch.equal(fused.positions, batched.positions)


@pytest.mark.parametrize("case", ["chain2", "mixed"])
def test_fused_batch_matches_reference(case):
    mixed = lambda rng, n: rng.choice([0.0, 0.05, 0.3, 0.5, 0.8, 1.0], n)  # noqa: E731
    tables, q = star_chain(2 if case == "chain2" else 4,
                           dist_p=mixed if case == "mixed" else None)
    ref, port, tq = engines(tables, q, PREFER)
    rplan = ref.compile(q, kernels="reference")
    tplan = port.compile(tq)
    assert tplan.route == "fused"
    acap = rplan.arrival_capacity()
    B = 6
    rkeys = jax.random.split(jax.random.key(21), B)
    want = ref.sample_batch(q, rkeys, kernels="reference")
    got = port.sample_batch(tq, t_threefry.keys(21, B))
    exact = 0
    for b in range(B):
        kd = np.asarray(jax.random.key_data(rkeys[b])).astype(np.uint32)
        v_ref, cells_ref = ref_arrivals(kd, rplan._dparams, acap)
        v_port = t_fd.arrivals(kd, acap, "cpu").numpy()
        diff = np.nonzero(cells_ref != _cells(v_port, tplan.draw_params))[0]
        if diff.size:
            assert near_boundary(v_ref, rplan._dparams, diff).all(), diff
            continue
        exact += 1
        np.testing.assert_array_equal(np.asarray(want.positions[b]),
                                      got.positions[b].numpy())
        assert int(want.count[b]) == int(got.count[b])
        assert bool(want.overflow[b]) == bool(got.overflow[b])
        for v, col in want.columns.items():
            np.testing.assert_array_equal(np.asarray(col[b]),
                                          got.columns[v][b].numpy())
    assert exact >= 3


def test_ptbern_batch_matches_reference_exactly():
    tables, q = star_chain(6)
    ref, port, tq = engines(tables, q, PREFER)
    assert port.compile(tq, method="ptbern_flat").route == "fused"
    B = 5
    want = ref.sample_batch(q, jax.random.split(jax.random.key(4), B),
                            method="ptbern_flat", kernels="reference")
    got = port.sample_batch(tq, t_threefry.keys(4, B), method="ptbern_flat")
    np.testing.assert_array_equal(np.asarray(want.positions),
                                  got.positions.numpy())
    np.testing.assert_array_equal(np.asarray(want.count), got.count.numpy())
    np.testing.assert_array_equal(np.asarray(want.overflow),
                                  got.overflow.numpy())
    for v, col in want.columns.items():
        np.testing.assert_array_equal(np.asarray(col), got.columns[v].numpy())


def test_sample_batch_empty_join():
    tables = {"Title": {"t": np.arange(3), "p": np.full(3, 0.5)},
              "Cast": {"t": np.array([7, 8]), "person": np.array([1, 2])}}
    _, tq = both_queries([("Title", ("t", "p"), None),
                          ("Cast", ("t", "person"), None)], "p")
    port = TQueryEngine(TDatabase.from_columns(tables, device="cpu"),
                        device="cpu", kernel_policy=PREFER)
    smp = port.sample_batch(tq, t_threefry.keys(0, 3))
    assert smp.positions.shape[0] == 3 and smp.batch == 3
    assert int(smp.count.sum()) == 0 and not bool(smp.overflow.any())
    assert not bool(smp.valid().any())


def test_sample_batch_requires_prob_var():
    tables, _ = star_chain(0)
    _, tq = both_queries([("Title", ("t", "kind", "p"), None),
                          ("Cast", ("t", "person"), None)], None)
    port = TQueryEngine(TDatabase.from_columns(tables, device="cpu"),
                        device="cpu")
    with pytest.raises(ValueError, match="prob_var"):
        port.sample_batch(tq, t_threefry.keys(0, 2))
    with pytest.raises(ValueError, match="prob_var"):
        port.compile(tq).sample_batch(t_threefry.keys(0, 2))


def test_warm_same_bucket_batch_zero_rebuilds():
    port, tq, _ = _route_engine("fused")
    port.sample_batch(tq, t_threefry.keys(0, 5))
    st0 = dict(vars(port.stats))
    assert st0["shred_builds"] == 1 and st0["plan_misses"] == 1
    port.sample_batch(tq, t_threefry.keys(1, 7))
    port.sample_batch(tq, t_threefry.keys(2, 8))
    assert port.stats.shred_builds == st0["shred_builds"]
    assert port.stats.plan_misses == st0["plan_misses"]
    assert port.stats.plan_hits >= st0["plan_hits"] + 2


def test_single_and_batched_share_one_plan():
    port, tq, _ = _route_engine("fused")
    port.sample(tq, t_threefry.key(0))
    misses, builds = port.stats.plan_misses, port.stats.shred_builds
    port.sample_batch(tq, t_threefry.keys(0, 4))
    port.uniform_sample(tq, t_threefry.key(1), 0.3)
    assert (port.stats.plan_misses, port.stats.shred_builds) == (misses,
                                                                  builds)


def test_batch_of_one_equals_the_single_draw():
    port, tq, _ = _route_engine("fused")
    keys = t_threefry.keys(9, 1)
    assert_lane_equal(port.sample_batch(tq, keys), port.sample(tq, keys[0]),
                      0)


# --- the batched wrappers on a fake library ----------------------------------

class _FakeLaunch:
    """``fused_draw_launch`` / ``fused_sample_launch`` that record their
    arguments and write nothing."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


@pytest.mark.parametrize("walk", [True, False])
def test_batched_wrappers_make_one_launch(monkeypatch, walk):
    """One launch a batch: the (B, 2) key words reach it as one device
    array (its pointer and B; the scalar key words 0), the scratch is B
    slabs and a barrier word, and the outputs carry the batch axis. The
    card is faked: ``params`` claim a CUDA device, tensors stay on the
    CPU."""
    calls = []
    port, tq, _ = _route_engine("fused")
    plan = port.compile(tq)
    pk = plan.shred.packed
    cuda = torch.device("cuda", 0)

    entries = {
        "fused_draw_launch": _FakeLaunch(calls, "fused_draw"),
        "fused_sample_launch": _FakeLaunch(calls, "fused_sample"),
        "fused_draw_scratch_words": lambda lanes, R, batch: batch * (
            6 * lanes + 2 * (R + 1) + 7 * (-(-lanes // 1024))) + 1}
    monkeypatch.setattr(t_fd, "_entry", lambda name: entries[name])
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: real_empty(
        *a, **{**k, "device": "cpu"}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(t_fd, "_device_keys", lambda keys, dev: torch.from_numpy(
        t_threefry.key_batch(keys).view(np.int32)))

    class FakeT:
        def __init__(self, t):
            self.t = t
            self.device, self.dtype, self.shape = cuda, t.dtype, t.shape

        def contiguous(self):
            return self

        def data_ptr(self):
            return self.t.data_ptr()

    fparams = {k: FakeT(v) for k, v in plan.draw_params.items()}
    keys = t_threefry.keys(2, 6)
    cap, acap = plan.default_capacity(), plan.arrival_capacity()
    if walk:
        arena = FakeT(pk.arena)
        rows, pos, cnt, ovf = t_fd.fused_draw_batch(
            arena, keys, fparams, layout=pk.layout, method="exprace",
            cap=cap, acap=acap)
        assert rows.shape == (6, pk.layout.num_slots, cap)
    else:
        pos, cnt, ovf = t_fd.fused_sample_batch(keys, fparams,
                                                method="exprace", cap=cap,
                                                acap=acap)
    assert pos.shape == (6, cap) and cnt.shape == (6,) and ovf.shape == (6,)
    assert len(calls) == 1
    name, args = calls[0]
    assert name == ("fused_draw" if walk else "fused_sample")
    off = 2 if walk else 0
    kptr, batch, k0, k1 = args[off:off + 4]
    assert batch == 6 and kptr is not None and (k0, k1) == (0, 0)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
