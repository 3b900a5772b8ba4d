"""The reference against brute force on tiny tables, the generators
against their cardinalities, and the yardstick's arithmetic."""
import json
import math

import numpy as np
import pytest
import torch

from portbench.lib import manifest
from portbench.metrics import _yardstick as ys
from portbench.reference import star as ref

ATOMS = [("R", ["k", "a", "p"]), ("S", ["k", "b"]), ("T", ["k", "c"])]


def tiny(seed, n_r=9, n_s=23, n_t=14, keys=7):
    rng = np.random.default_rng(seed)
    return {"R": {"k": rng.integers(0, keys, n_r), "a": rng.integers(0, 5, n_r),
                  "p": rng.random(n_r)},
            "S": {"k": rng.integers(0, keys, n_s), "b": rng.integers(0, 9, n_s)},
            "T": {"k": rng.integers(0, keys, n_t), "c": rng.integers(0, 9, n_t)}}


def torch_tables(t):
    return {r: {c: torch.as_tensor(v) for c, v in cols.items()}
            for r, cols in t.items()}


def brute(t):
    """Every join row in the canonical order, by nested loops."""
    rows = []
    for i in range(len(t["R"]["k"])):
        k = t["R"]["k"][i]
        for j in range(len(t["S"]["k"])):
            if t["S"]["k"][j] != k:
                continue
            for m in range(len(t["T"]["k"])):
                if t["T"]["k"][m] == k:
                    rows.append((k, t["R"]["a"][i], t["R"]["p"][i],
                                 t["S"]["b"][j], t["T"]["c"][m]))
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_the_join_equals_brute_force(seed):
    t = tiny(seed)
    want = brute(t)
    s = ref.Star(torch_tables(t), ATOMS, "p")
    assert s.size == len(want)
    got = s.rows_at(torch.arange(s.size))
    for i, v in enumerate(["k", "a", "p", "b", "c"]):
        assert [r[i] for r in want] == got[v].tolist(), v
    assert math.isclose(s.expected_k(), sum(r[2] for r in want),
                        rel_tol=1e-12, abs_tol=1e-12)
    assert math.isclose(s.variance_k(), sum(r[2] * (1 - r[2]) for r in want),
                        rel_tol=1e-12, abs_tol=1e-12)
    assert math.isclose(s.expected_p_sum(), sum(r[2] ** 2 for r in want),
                        rel_tol=1e-12, abs_tol=1e-12)
    assert math.isclose(s.variance_p_sum(),
                        sum(r[2] ** 3 * (1 - r[2]) for r in want),
                        rel_tol=1e-12, abs_tol=1e-12)


def test_rows_at_any_positions_equal_the_expansion():
    t = tiny(11, n_r=40, n_s=90, n_t=70, keys=12)
    s = ref.Star(torch_tables(t), ATOMS, "p")
    full = s.rows_at(torch.arange(s.size))
    pos = torch.randperm(s.size, generator=torch.Generator().manual_seed(0))
    some = s.rows_at(pos[:50])
    for v in full:
        assert torch.equal(some[v], full[v][pos[:50]])


def test_the_reference_is_the_programs_canonical_order():
    """The port's full join on the CPU lists the same rows in the same
    order (the order its positions index)."""
    from repro_torch.core import Atom, Database, JoinQuery
    from repro_torch.engine import QueryEngine

    t = tiny(3, n_r=30, n_s=80, n_t=50, keys=10)
    q = JoinQuery(tuple(Atom.of(r, *v) for r, v in ATOMS), prob_var="p")
    full = QueryEngine(Database.from_columns(t, device="cpu"),
                       device="cpu").full_join(q)
    s = ref.Star(torch_tables(t), ATOMS, "p")
    want = s.rows_at(torch.arange(s.size))
    for v in want:
        assert torch.equal(full[v], want[v]), v


@pytest.mark.parametrize("seed", range(4))
def test_apply_delta_equals_survivors_then_inserts(seed):
    t = tiny(seed)
    rng = np.random.default_rng(seed)
    dele = rng.choice(23, 5, replace=False)
    ins = {"k": rng.integers(0, 7, 4), "b": rng.integers(0, 9, 4)}
    got = ref.apply_delta(torch_tables(t), {"S": {"delete": dele,
                                                  "insert": ins}})
    keep = [i for i in range(23) if i not in set(dele.tolist())]
    for c in ("k", "b"):
        want = [t["S"][c][i] for i in keep] + list(ins[c])
        assert got["S"][c].tolist() == want
    assert got["R"] is not None and torch.equal(got["R"]["p"],
                                                torch.as_tensor(t["R"]["p"]))


def test_the_plain_sampler_is_poisson_in_float64():
    """Counts of float64 draws over many seeds: mean within 5 sd of E[k],
    every position a join row, strictly increasing."""
    t = tiny(5, n_r=50, n_s=300, n_t=200, keys=20)
    s = ref.Star(torch_tables(t), ATOMS, "p")
    counts = []
    for i in range(200):
        pos = ref.poisson_sample(s, torch.Generator().manual_seed(i))
        assert bool((pos[1:] > pos[:-1]).all())
        assert int(pos.min()) >= 0 and int(pos.max()) < s.size
        counts.append(pos.numel())
    z = (sum(counts) - 200 * s.expected_k()) / math.sqrt(200 * s.variance_k())
    assert abs(z) < 5, z


def test_each_row_is_kept_with_its_p():
    """One root row of p 0.9 and one of p 0.1, each with 100 join rows:
    their kept shares over 200 draws."""
    t = {"R": {"k": np.array([0, 1]), "a": np.array([0, 0]),
               "p": np.array([0.9, 0.1])},
         "S": {"k": np.array([0] * 10 + [1] * 10), "b": np.arange(20)},
         "T": {"k": np.array([0] * 10 + [1] * 10), "c": np.arange(20)}}
    s = ref.Star(torch_tables(t), ATOMS, "p")
    kept = torch.zeros(2)
    for i in range(200):
        pos = ref.poisson_sample(s, torch.Generator().manual_seed(i))
        kept += torch.bincount((pos >= 100).long(), minlength=2)
    share = kept / (200 * 100)
    assert abs(float(share[0]) - 0.9) < 0.01 and abs(float(share[1]) - 0.1) < 0.01


def tpch(seed, scale):
    conf = json.loads((manifest.HERE / "configs" / "tpch-sf10.json").read_text())
    gen = manifest.load_module(manifest.HERE / "gen" / "tpch-sf10.py")
    return conf, gen.make(conf, seed, scale)


def test_the_generator_hits_its_cardinalities():
    conf, t = tpch(7, 0.001)
    atoms = conf["query"]["atoms"]
    assert list(t) == [a[0] for a in atoms]
    for rel, vs in atoms:
        assert list(t[rel]) == vs
        n = round(conf["tables"][rel]["rows"] * 0.001)
        assert all(v.shape == (n,) for v in t[rel].values()), rel
    _, again = tpch(7, 0.001)
    _, other = tpch(8, 0.001)
    assert np.array_equal(again["Part"]["p"], t["Part"]["p"])
    assert not np.array_equal(other["Part"]["p"], t["Part"]["p"])


def test_the_generator_keeps_the_specifications_rules():
    """Four ``partsupp`` rows a part with four distinct suppliers by the
    specification's formula, part keys in range, sizes and quantities in
    1 .. 50; so every seed has the same join, four rows a line item."""
    conf, t = tpch(3, 0.005)
    n_part = len(t["Part"]["pk"])
    s = round(conf["suppliers"] * 0.005)
    assert np.array_equal(t["PartSupp"]["pk"], np.repeat(np.arange(n_part), 4))
    supp = t["PartSupp"]["supp"].reshape(-1, 4)
    assert supp.min() >= 1 and supp.max() <= s
    assert all(len(set(r)) == 4 for r in supp.tolist())
    key = np.arange(1, n_part + 1)
    want = (key + 2 * (s // 4 + (key - 1) // s)) % s + 1
    assert np.array_equal(supp[:, 2], want)
    li = t["Lineitem"]
    assert li["pk"].min() >= 0 and li["pk"].max() < n_part
    for col in (t["Part"]["size"], li["qty"]):
        assert col.min() == 1 and col.max() == 50
    stars = [ref.Star(torch_tables(tpch(sd, 0.005)[1]), conf["query"]["atoms"],
                      "p") for sd in (1, 2**31 + 3)]
    assert stars[0].size == stars[1].size == 4 * len(li["pk"])


def test_the_yardstick():
    assert ys.percentile([1, 2, 3, 4], 0.5) == 2
    assert ys.percentile(list(range(1, 101)), 0.95) == 95
    assert ys.busy_union([(5, 7), (0, 2), (1, 3)]) == [(0, 3), (5, 7)]
    assert ys.idle_gaps([(0, 3), (5, 7)], 0, 10) == [(3, 5), (7, 10)]
    assert ys.top_by_name([("a", 1.0), ("b", 3.0), ("a", 2.5)], 1) == [["a", 3.5]]
    nbytes, nops = ys.get_work([10, 20, 30], 100, 700)
    assert nbytes == 4 * 100 + 4 * 60 + 4 * 100 * 3
    assert nops == 6 * 700 + 12 * 100 * 3
    assert ys.bound_s(3.35e12, 0) == 1.0
    # two keys drawing 3 and 5 rows over 10 roots, children of 20 and 30
    nbytes, nops = ys.draw_batch_work(10, [20, 30], 4.0, [3, 5], walk=False)
    assert nbytes == 4 * 7 * 11 + 4 * (8 + 2 * 2)
    walked, wops = ys.draw_batch_work(10, [20, 30], 4.0, [3, 5], walk=True)
    assert walked == nbytes + 4 * (11 + 50) + 4 * 8 * 3
    assert wops == nops + 8 * (6 * ys.steps(11) + 6 * ys.steps(21) + 12
                               + 6 * ys.steps(31) + 12)


def test_the_gets_searches_follow_the_key_groups():
    """Each position's search over the roots' prefix and, in each child,
    over its key group: counted from the tables, position by position."""
    t = tiny(9, n_r=30, n_s=80, n_t=50, keys=10)
    s = ref.Star(torch_tables(t), ATOMS, "p")
    deg = [np.bincount(t[r]["k"], minlength=10) for r in ("S", "T")]
    want = sum(ys.steps(31) + sum(ys.steps(d[k]) for d in deg)
               for k in t["R"]["k"] for _ in range(deg[0][k] * deg[1][k]))
    got = ys.get_search_steps(30, s.w, s.key_degrees())
    assert got == want
