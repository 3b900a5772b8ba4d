"""The rest of a run, on the CPU at a small scale, with the timed path
broken underneath: ``correct`` comes out false for each fault a cell can
have, true for the sound program, and false for the control (the
reference one precision lower in the program's place) and for the
reference with its rows' p taken wrongly."""
import time
from types import SimpleNamespace

import pytest
import torch

from portbench.control import control_engine
from portbench.lib import manifest
from portbench.lib.bench import run_cell

SCALE = 2e-4
CPU = torch.device("cpu")
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def run(cell, maker=None, seed=2**31 + 5, scale=SCALE, seconds=0.4):
    return run_cell(cell, seed, seconds, False, CPU, time.perf_counter(),
                    scale=scale, engine_factory=maker)


def wrapping(cls):
    from repro_torch.engine import QueryEngine

    def maker(tables, config, device):
        return lambda db: cls(QueryEngine(db, device=device))
    return maker


class Through:
    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)


class HalfBatch(Through):
    """Draws only the first half of the keys; the rest repeat them."""

    def sample_batch(self, query, keys, **kw):
        half = max(1, len(keys) // 2)
        s = self.inner.sample_batch(query, keys[:half], **kw)
        idx = torch.arange(len(keys)) % half
        return SimpleNamespace(positions=s.positions[idx], count=s.count[idx],
                               overflow=s.overflow[idx],
                               columns={v: c[idx] for v, c in s.columns.items()})


class AlteredDraw(Through):
    """One row of every batch altered where it is produced."""

    def sample_batch(self, query, keys, **kw):
        s = self.inner.sample_batch(query, keys, **kw)
        s.columns[sorted(s.columns)[-1]][0, 0] += 1
        return s


class AlteredJoin(Through):
    """One row of every full join altered where it is produced."""

    def full_join(self, query, **kw):
        full = self.inner.full_join(query, **kw)
        col = full[sorted(full)[-1]]
        col[len(col) // 2] += 1
        return full


class HalfJoin(Through):
    """The full join's second half left out."""

    def full_join(self, query, **kw):
        full = self.inner.full_join(query, **kw)
        n = len(next(iter(full.values()))) // 2
        return {v: c[:n] for v, c in full.items()}


class Unchanged(Through):
    """An update that returns the state unchanged."""

    def apply_delta(self, delta):
        return self


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("cell,fault,number", [
    ("tpch-sf10.draws", HalfBatch, "same_draws"),
    ("tpch-sf10.churn", HalfBatch, "same_draws"),
    ("tpch-sf10.draws", AlteredDraw, "bad_rows"),
    ("tpch-sf10.churn", AlteredDraw, "bad_rows"),
    ("tpch-sf10.join", AlteredJoin, "bad_join_rows"),
    ("tpch-sf10.join", HalfJoin, "bad_join_rows"),
    ("tpch-sf10.churn", Unchanged, "bad_snapshot"),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, number):
    out = run(cell, wrapping(fault))
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = run(cell, control_engine("float32"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_at_full_precision_is_correct(cell):
    out = run(cell, control_engine("float64"))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["mean_p", "next_p"])
@pytest.mark.parametrize("cell", ["tpch-sf10.draws", "tpch-sf10.churn"])
def test_draws_with_the_wrong_p_are_not_correct(cell, fault):
    """Rows kept with the join's mean p, or with the next part's p, read
    back as the table's rows at their positions: only ``p_sum_z`` sees
    them."""
    out = run(cell, control_engine("float64", fault), scale=1e-3)
    assert not out["correct"]
    assert out["checks"]["bad_rows"]["value"] == 0
    assert out["checks"]["p_sum_z"]["value"] > out["checks"]["p_sum_z"]["limit"]
