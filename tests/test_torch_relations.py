"""The port's ``Relation`` and ``CapacityPolicy.flatten_capacity`` against
the reference's on the same numpy columns, drawn from a seed: ``attrs``,
``rename``, ``take`` (rows repeated and out of order), ``concat``,
``to_numpy`` and ``from_numpy`` column for column, exactly; and the
sharded full join's lane-rounded capacity for a few shard sizes and lane
multiples, integer for integer."""
import numpy as np
import pytest
import torch

from repro.core.relations import Relation as RRelation
from repro.engine.capacity import CapacityPolicy as RCapacityPolicy
from repro_torch.core import Relation
from repro_torch.engine.capacity import CapacityPolicy


def _columns(seed: int, n: int = 37):
    rng = np.random.default_rng(seed)
    return {"t": rng.integers(0, 1000, n), "p": rng.random(n),
            "actor": rng.integers(-5, 5, n).astype(np.int32)}


def _pair(seed: int):
    cols = _columns(seed)
    return (Relation.from_numpy(cols, device="cpu"),
            RRelation.from_numpy(cols))


def _same(got: Relation, want: RRelation):
    assert got.attrs == want.attrs
    g, w = got.to_numpy(), want.to_numpy()
    assert set(g) == set(w)
    for a in w:
        np.testing.assert_array_equal(g[a], w[a])
        assert g[a].dtype == w[a].dtype, a


@pytest.mark.parametrize("seed", [0, 1])
def test_from_numpy_and_to_numpy(seed):
    got, want = _pair(seed)
    _same(got, want)
    assert got.num_rows == want.num_rows == 37
    assert all(v.device.type == "cpu" for v in got.columns.values())


@pytest.mark.parametrize("mapping", [{"t": "title"}, {"p": "q", "actor": "a"},
                                     {"missing": "x"}])
def test_rename(mapping):
    got, want = _pair(2)
    _same(got.rename(mapping), want.rename(mapping))


@pytest.mark.parametrize("seed", [3, 4])
def test_take(seed):
    got, want = _pair(seed)
    rows = np.random.default_rng(seed + 10).integers(0, 37, 50)
    _same(got.take(torch.as_tensor(rows)), want.take(rows))
    _same(got.take(torch.as_tensor(rows[:0])), want.take(rows[:0]))


def test_concat():
    (a, ra), (b, rb) = _pair(5), _pair(6)
    _same(a.concat(b), ra.concat(rb))
    with pytest.raises(AssertionError):
        a.concat(a.project(["t"]))


@pytest.mark.parametrize("multiple", [1, 8, 128])
@pytest.mark.parametrize("shard_join", [0, 1, 127, 128, 129, 10_000_019])
def test_flatten_capacity(multiple, shard_join):
    got = CapacityPolicy(lane_multiple=multiple).flatten_capacity(shard_join)
    want = RCapacityPolicy(lane_multiple=multiple).flatten_capacity(shard_join)
    assert isinstance(got, int) and got == want
