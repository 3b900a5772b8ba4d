"""The port's CSR index and GET against the JAX reference.

The same numpy tables go into ``repro`` and ``repro_torch`` (on the CPU).
``rep='csr'`` builds the successor chains array for array as the
reference does; ``csr_get_rows`` resolves every position (and sentinel
lanes past the join) to the reference's rows exactly — weight-0 rows,
empty runs and cross products included — and to the port's USR GET on the
same index; the engine's CSR full join equals the reference engine's.
"""
import numpy as np
import pytest
import torch

from repro.core import Database, build_shred, probe
from repro.engine import QueryEngine
from repro_torch.config import KernelPolicy
from repro_torch.core import Database as TDatabase
from repro_torch.core import build_shred as t_build_shred
from repro_torch.core import probe as t_probe
from repro_torch.engine import QueryEngine as TQueryEngine

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
