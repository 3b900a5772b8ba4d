"""The port's CSR index and GET against the JAX reference.

The same numpy tables go into ``repro`` and ``repro_torch`` (on the CPU).
``rep='csr'`` builds the successor chains array for array as the
reference does; ``csr_get_rows`` resolves every position (and sentinel
lanes past the join) to the reference's rows exactly — weight-0 rows,
empty runs and cross products included — and to the port's USR GET on the
same index; the engine's CSR full join equals the reference engine's.
``csr_get_rows_cached`` (the paper's caching walk over ascending probes)
equals the reference's exactly, the walk kernel's two plain versions agree
with each other lane for lane (runs the cache resumes, offsets that fall
back below what was consumed, weight-0 rows, empty runs), and
``pack_keys`` / ``pack_arena`` equal the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import Database, build_shred, probe
from repro.core import pack_arena as r_pack_arena
from repro.core import pack_keys as r_pack_keys
from repro.engine import QueryEngine
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.core import build_shred as t_build_shred
from repro_torch.core import probe as t_probe
from repro_torch.core import pack_arena, pack_keys
from repro_torch.engine import QueryEngine as TQueryEngine
from repro_torch.kernels import csr_walk

from test_torch_shred import (CASES, assert_same, both_dbs, both_queries,
                              ref_arrays)

PREFER = KernelPolicy(prefer=True)


def _positions(n):
    """Every position of the join, then sentinel lanes past it."""
    return np.concatenate([np.arange(n), np.arange(n, n + 5)]).astype(np.int64)


def _case(case, rep):
    tables, atoms, prob_var = CASES[case]
    rdb, tdb = both_dbs(tables)
    rq, tq = both_queries(atoms, prob_var)
    return build_shred(rdb, rq, rep=rep), t_build_shred(tdb, tq, rep=rep)


@pytest.mark.parametrize("policy", [None, PREFER], ids=["plain", "kernels"])
@pytest.mark.parametrize("rep", ["csr", "both"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_csr_get_rows_matches_reference(case, rep, policy):
    ref, port = _case(case, rep)
    assert_same(ref_arrays(ref), ref_arrays(port))
    n = int(port.join_size)
    if n == 0:  # no position to resolve (callers guard an empty join)
        return
    pos = _positions(n)
    want = probe.csr_get_rows(ref, pos)
    kw = {} if policy is None else {"policy": policy}
    got = t_probe.csr_get_rows(port, torch.as_tensor(pos), **kw)
    assert set(want) == set(got)
    for name, rows in want.items():
        assert got[name].dtype == torch.int32, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(rows),
                                      err_msg=name)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_csr_get_rows_equals_usr_get_rows(case):
    """On one index (rep 'both') the two GETs give the same rows at every
    position of the join."""
    _, port = _case(case, "both")
    n = int(port.join_size)
    if n == 0:
        return
    pos = torch.arange(n)
    csr = t_probe.csr_get_rows(port, pos)
    usr = t_probe.usr_get_rows(port, pos)
    for name, rows in usr.items():
        assert torch.equal(csr[name], rows), name
    assert t_probe.get_rows(port, pos, rep="csr").keys() == usr.keys()


def test_csr_get_skips_weight_zero_rows_and_empty_runs():
    """Dangling rows (weight 0) in the middle of chains and parents whose
    run is empty: the walk skips the first and never starts the second."""
    tables = {
        "R": {"x": [1, 2, 3, 1], "p": [0.5, 0.5, 0.5, 0.5]},
        "S": {"x": [1, 1, 9, 1, 2, 1], "y": [0, 7, 1, 0, 5, 0]},
        "T": {"y": [0, 0, 5, 1], "z": [1, 2, 3, 4]},
    }
    atoms = [("R", ("x", "p"), None), ("S", ("x", "y"), None),
             ("T", ("y", "z"), None)]
    rdb, tdb = both_dbs(tables)
    rq, tq = both_queries(atoms, "p")
    ref = build_shred(rdb, rq, rep="csr")
    port = t_build_shred(tdb, tq, rep="csr")
    assert_same(ref_arrays(ref), ref_arrays(port))
    s_node = port.root.children[0]
    assert (s_node.weight == 0).any()             # S rows with no T match
    assert (port.root.child_len[0] == 0).any()    # R row 3's run is empty
    pos = _positions(int(port.join_size))
    want = probe.csr_get_rows(ref, pos)
    got = t_probe.csr_get_rows(port, torch.as_tensor(pos))
    for name, rows in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(rows))


def test_csr_get_on_a_usr_index_raises():
    _, port = _case(0, "usr")
    with pytest.raises(AssertionError, match="CSR"):
        t_probe.csr_get_rows(port, torch.arange(2))
    # the default GET of a CSR-only index is the CSR GET
    _, csr = _case(0, "csr")
    pos = torch.arange(int(csr.join_size))
    for name, rows in t_probe.get_rows(csr, pos).items():
        assert torch.equal(rows, t_probe.csr_get_rows(csr, pos)[name])


@pytest.mark.parametrize("policy", [None, PREFER], ids=["plain", "kernels"])
@pytest.mark.parametrize("case", [3, 12, len(CASES) - 1])
def test_engine_csr_full_join_matches_reference(case, policy):
    tables, atoms, prob_var = CASES[case]
    rq, tq = both_queries(atoms, prob_var)
    want = QueryEngine(Database.from_columns(tables), rep="csr").full_join(rq)
    port = TQueryEngine(TDatabase.from_columns(tables, device="cpu"),
                        rep="csr", device="cpu", kernel_policy=policy)
    assert port.compile(tq).rep_default == "csr"
    got = port.full_join(tq)
    usr = TQueryEngine(port.db, device="cpu",
                       kernel_policy=policy).full_join(tq)
    assert set(want) == set(got)
    for v, col in want.items():
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(col))
        assert torch.equal(got[v], usr[v]), v
    # a CSR full join asked of a USR engine builds its own CSR index
    via_spec = TQueryEngine(port.db, device="cpu",
                            kernel_policy=policy).full_join(tq, rep="csr")
    for v, col in usr.items():
        assert torch.equal(via_spec[v], col), v


# -- the caching walk (Fig. 11) ---------------------------------------------------

@pytest.mark.parametrize("case", range(len(CASES)))
def test_csr_get_rows_cached_matches_reference(case):
    """Every position of the join in ascending order (then sentinel lanes
    past it): the reference's scan and the port's walk give the same rows,
    and the same rows as the uncached GET."""
    ref, port = _case(case, "csr")
    n = int(port.join_size)
    if n == 0:
        return
    pos = _positions(n)
    want = probe.csr_get_rows_cached(ref, pos)
    got = t_probe.csr_get_rows_cached(port, torch.as_tensor(pos), PREFER)
    plain = t_probe.csr_get_rows(port, torch.as_tensor(pos))
    assert set(want) == set(got)
    for name, rows in want.items():
        assert got[name].dtype == torch.int32, name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(rows),
                                      err_msg=name)
        assert torch.equal(got[name], plain[name]), name


def test_csr_get_rows_cached_resumes_runs_over_weight_zero_rows():
    """One chain of six rows, two of weight 0, under one head: ascending
    probes resume the walk (the cache's case) and land on the reference's
    rows; a probe below what was consumed restarts from the head."""
    tables = {
        "R": {"x": [1, 1, 2], "p": [0.5, 0.5, 0.5]},
        "S": {"x": [1, 1, 1, 1, 1, 1, 2], "y": [0, 9, 1, 0, 9, 1, 1]},
        "T": {"y": [0, 0, 1], "z": [1, 2, 3]},
    }
    atoms = [("R", ("x", "p"), None), ("S", ("x", "y"), None),
             ("T", ("y", "z"), None)]
    rdb, tdb = both_dbs(tables)
    rq, tq = both_queries(atoms, "p")
    ref = build_shred(rdb, rq, rep="csr")
    port = t_build_shred(tdb, tq, rep="csr")
    s_node = port.root.children[0]
    assert (s_node.weight == 0).sum() == 2       # S rows with y = 9
    n = int(port.join_size)
    pos = np.arange(n, dtype=np.int64)
    want = probe.csr_get_rows_cached(ref, pos)
    got = t_probe.csr_get_rows_cached(port, torch.as_tensor(pos))
    for name, rows in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(rows))
    # R's rows 0 and 1 share S's chain: the second restarts from the head
    hd = port.root.child_hd[0]
    assert int(hd[0]) == int(hd[1]) >= 0


def _chains(rng, n_rows, n_keys):
    """A child of ``n_rows`` rows (weights 0-3, a quarter 0) in
    ``n_keys`` same-key chains: (weight, nxt, heads)."""
    key = rng.integers(0, n_keys, n_rows)
    weight = rng.integers(0, 4, n_rows) * (rng.random(n_rows) > 0.25)
    nxt = np.full(n_rows, -1, np.int32)
    heads = np.full(n_keys, -1, np.int32)
    for k in range(n_keys):
        rows = np.flatnonzero(key == k)
        if rows.size:
            heads[k] = rows[0]
            nxt[rows[:-1]] = rows[1:]
    return (torch.as_tensor(weight.astype(np.int64)), torch.as_tensor(nxt),
            heads, key, weight)


@pytest.mark.parametrize("seed", range(4))
def test_cached_walk_plain_equals_uncached(seed):
    """The two plain versions of the walk kernel on the same probes: runs
    of equal heads with ascending offsets (resumed), offsets that drop
    below what was consumed (restarted), offsets past a chain's weight
    (row -1), empty runs (head -1)."""
    rng = np.random.default_rng(seed)
    weight, nxt, heads, key, w_np = _chains(rng, 60, 7)
    heads = np.append(heads, -1)                   # an empty run
    runs = rng.integers(0, heads.size, 40)
    hd, idx = [], []
    for k in runs:
        total = int(w_np[key == k].sum()) if k < heads.size - 1 else 0
        m = int(rng.integers(1, 6))
        offs = np.sort(rng.integers(0, total + 3, m))
        if rng.random() < 0.3:
            offs = offs[::-1]                       # not ascending
        hd += [heads[k]] * m
        idx += offs.tolist()
    hd = torch.as_tensor(np.asarray(hd, np.int32))
    idx = torch.as_tensor(np.asarray(idx, np.int64))
    row, rem = csr_walk.csr_walk(weight, nxt, hd, idx)
    crow, crem = csr_walk.csr_walk_cached(weight, nxt, hd, idx)
    assert row.dtype == crow.dtype == torch.int32
    assert rem.dtype == crem.dtype == torch.int64
    assert torch.equal(row, crow) and torch.equal(rem, crem)
    assert (row == -1).any() and (row >= 0).any()
    assert csr_walk.csr_walk.launches == csr_walk.csr_walk_cached.launches == 0


def test_csr_walk_checks_its_operands():
    w = torch.zeros(3, dtype=torch.int64)
    nxt = torch.full((3,), -1, dtype=torch.int32)
    hd = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="idx"):
        csr_walk.csr_walk(w, nxt, hd, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="match"):
        csr_walk.csr_walk_cached(w, nxt, hd, torch.zeros(3, dtype=torch.int64))
    row, rem = csr_walk.csr_walk(w, nxt, hd[:0], torch.zeros(0, dtype=torch.int64))
    assert row.shape == rem.shape == (0,)


# -- pack_keys and pack_arena ----------------------------------------------------

def test_pack_keys_matches_reference():
    rng = np.random.default_rng(5)
    radices = (7, 300, 2**20)
    cols = [rng.integers(0, r, 50) for r in radices]
    for k in (1, 2, 3):
        want = r_pack_keys([np.asarray(c) for c in cols[:k]], radices[:k])
        got = pack_keys([torch.as_tensor(c) for c in cols[:k]], radices[:k])
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", [0, 9, len(CASES) - 1])
def test_pack_arena_matches_reference(case):
    """The monolith alone, as the reference packs it; ``None`` for an
    empty node and over the draw budget (the reference's VMEM budget)."""
    ref, port = _case(case, "usr")
    want = r_pack_arena(ref.root, ref.root_prefE)
    got = pack_arena(port.root, port.root_prefE)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.arena.numpy(), np.asarray(want.arena))
    assert got.layout.size == want.layout.size
    assert tuple(got.layout.names) == tuple(want.layout.names)
    small = KernelPolicy(draw_limit=got.layout.size - 1)
    assert pack_arena(port.root, port.root_prefE, small) is None
