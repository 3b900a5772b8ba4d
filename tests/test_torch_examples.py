"""The port's four reference examples, on the CPU.

  * EpiQL (``examples/epiql_contact_sim.py``, the paper's Example 1.1) at
    ``--pop 300 --days 3``: the contact join's size and expected daily
    contacts equal the reference's on the same tables; each day's contact
    count lies within 6 sd of ``expected_k`` (the days draw through the
    port's own generators, so they are checked by distribution); a day
    folds its key as ``jax.random.fold_in`` does;
  * at a population of 100,000 (the contact join 133 M tuples, E[k] 3.2 M
    a day) the float32 fused draw falls 5% short of E[k], as the
    reference's own fused pipeline does on the same day's key: its
    arrival sum's ulp (0.25 at the total mass) spans about ten cells of
    rate 0.024, and arrivals in one cell merge. The port keeps the
    reference's routing by arena size (ROADMAP C); the per-node route
    (float64) holds E[k];
  * the quickstart: the join's size and its full join equal a numpy
    expansion of the tiny movie database, and every sampled row is a join
    tuple;
  * serve_lm: ``--mode lm`` at the reduced config prints what
    ``launch.serve.main`` prints for the same arguments (the served tokens
    and the kernels' launches; the times apart), and no option defaults it
    to the join service. Its tokens are held to the reference's by
    ``tests/test_torch_serve_lm.py``, so this case runs no JAX;
  * train_lm_joinsampled has tests of its own
    (``tests/test_torch_train.py``).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax

from repro.engine import QueryEngine as RQueryEngine
from repro_torch.config import KernelPolicy
from repro_torch.core import estimate
from repro_torch.engine import QueryEngine
from repro_torch.examples import epiql_contact_sim, quickstart, serve_lm
from repro_torch.launch import serve
from repro_torch.kernels import threefry

REFERENCE = Path(__file__).resolve().parents[1] / "examples"
Z_LIMIT = 6.0


def _reference_example(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  REFERENCE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_epiql_join_and_daily_contacts(capsys):
    out = epiql_contact_sim.main(["--pop", "300", "--days", "3", "--device",
                                  "cpu"])
    ref = _reference_example("epiql_contact_sim")
    db, q = ref.build_population(300, 75, 6, seed=0)
    plan = RQueryEngine(db).compile(q)
    assert out["join_size"] == plan.join_size
    assert np.isclose(out["expected_k"], plan.expected_k(), rtol=1e-12)
    assert len(out["days"]) == 3
    for day, k, new, ms in out["days"]:
        assert abs(k - out["expected_k"]) <= Z_LIMIT * out["sd_k"], (day, k)
        assert 0 <= new <= 300 and ms > 0
    assert 0 < out["attack_rate"] <= 1
    assert "contact-join size=" in capsys.readouterr().out
    # the day's key: jax.random.fold_in of the simulation's key
    want = jax.random.key_data(jax.random.fold_in(jax.random.key(42), 2))
    np.testing.assert_array_equal(threefry.fold_in(threefry.key(42), 2),
                                  np.asarray(want))


def test_epiql_fused_draw_falls_short_at_scale_as_the_reference():
    pop = 100_000
    db, q = epiql_contact_sim.build_population(pop, 75, 6, 0, device="cpu")
    plan = QueryEngine(db, device="cpu",
                       kernel_policy=KernelPolicy(prefer=True)).compile(q)
    assert plan.route == "fused" and plan.join_size == 133_439_882
    E = plan.expected_k()
    sd = float(estimate.sample_std(plan.w, plan.p))
    key = threefry.fold_in(threefry.key(42), 0)
    fused = int(plan.sample(key).count)
    pernode = int(plan.sample(key, rep=plan.rep_default).count)
    ref = _reference_example("epiql_contact_sim")
    rdb, rq = ref.build_population(pop, 75, 6, seed=0)
    rplan = RQueryEngine(rdb).compile(rq, kernels="reference")
    want = int(rplan.sample(jax.random.fold_in(jax.random.key(42), 0)).count)
    assert np.isclose(rplan.expected_k(), E, rtol=1e-12)
    assert (fused - E) / sd < -50 and (want - E) / sd < -50
    assert abs(fused - want) <= 1e-4 * E  # the same shortfall, to 0.01%
    assert abs(pernode - E) <= Z_LIMIT * sd


def test_quickstart_join_and_samples(capsys):
    out = quickstart.main(["--device", "cpu"])
    cast = {0: [10, 11], 1: [12, 13, 14], 2: [15], 3: [16]}
    comp = {0: [100], 1: [101, 102], 2: [103], 3: [104, 105]}
    p = {0: 0.9, 1: 0.5, 2: 0.1, 3: 0.7}
    join = {(t, a, c, p[t]) for t in cast for a in cast[t] for c in comp[t]}
    assert out["join_size"] == out["full_join_rows"] == len(join) == 11
    assert len(out["samples"]) == 3
    for rows in out["samples"]:
        assert len(set(rows)) == len(rows)
        assert all((int(t), int(a), int(c), float(pp)) in join
                   for t, a, c, pp in rows)
    assert "full join tuples: 11" in capsys.readouterr().out


def _served(text: str) -> list:
    """The lines of an LM serving run with its wall-clock figures cut: the
    head line up to its token count, the requests' tokens, the kernels'
    launches."""
    lines = []
    for line in text.splitlines():
        if line.startswith("[serve] ") and " tokens in " in line:
            line = line.split(" in ")[0]
        lines.append(line)
    return lines


@pytest.mark.parametrize("argv", [
    ["--mode", "lm", "--batch", "2", "--max-new", "3"],
    ["--batch", "1", "--max-new", "2", "--arch", "gemma3_1b"]])
def test_serve_lm_prints_what_serve_prints(capsys, argv):
    argv = argv + ["--device", "cpu"]
    assert serve_lm.main(argv) == 0
    got = capsys.readouterr().out
    assert serve.main(["--mode", "lm"] + argv) == 0
    want = capsys.readouterr().out
    assert _served(got) == _served(want)
    assert "(reduced) on cpu" in got and "[serve] kernels " in got
