"""The port's index build against the JAX reference, array for array.

The same numpy columns go into ``repro`` and ``repro_torch`` (on the CPU);
every node array, the packed int32 arena and its layout must be equal,
dtypes included, over the query shapes of tests/test_shred_probe.py.
``ref_arrays`` (reused by the other ``test_torch_*`` files) carries a
reference index, packed or paged, across as plain numpy arrays for
``shred_from_arrays``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import Atom, Database, JoinQuery, build_shred
from repro_torch.config import KernelPolicy
from repro_torch.core import Atom as TAtom
from repro_torch.core import Database as TDatabase
from repro_torch.core import JoinQuery as TJoinQuery
from repro_torch.core import build_shred as t_build_shred
from repro_torch.core import dense_keys as t_dense_keys
from repro_torch.core import shred_from_arrays


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def ref_arrays(shred):
    """A shred of either package as the nested numpy dict that
    ``repro_torch.core.shred_from_arrays`` takes."""
    def opt(a):
        return None if a is None else _np(a)

    def node(nd):
        return {
            "name": nd.name, "variables": tuple(nd.variables),
            "owned": tuple(nd.owned),
            "data": {c: _np(v) for c, v in nd.data.columns.items()},
            "weight": _np(nd.weight), "perm": opt(nd.perm),
            "cumw_excl": opt(nd.cumw_excl), "nxt": opt(nd.nxt),
            "child_start": [_np(a) for a in nd.child_start],
            "child_w": [_np(a) for a in nd.child_w],
            "child_len": [_np(a) for a in nd.child_len],
            "child_hd": [_np(a) for a in nd.child_hd],
            "children": [node(c) for c in nd.children],
        }

    packed, paged = shred.packed, getattr(shred, "paged", None)
    out = {"rep": shred.rep, "root_prefE": _np(shred.root_prefE),
           "root": node(shred.root), "arena": None, "pages": None,
           "layout": None}
    if packed is not None:
        out["arena"] = _np(packed.arena)
    if paged is not None:
        out["pages"] = [_np(p) for p in paged.pages]
    form = packed if packed is not None else paged
    if form is not None:
        lay = form.layout
        out["layout"] = {"names": tuple(lay.names), "n_root": lay.n_root,
                         "root_len": lay.root_len, "size": lay.size,
                         "edges": [dataclasses.astuple(e) for e in lay.edges]}
    return out


def assert_same(a, b, path="shred"):
    """Recursive equality of two ``ref_arrays`` trees, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def both_dbs(tables):
    return (Database.from_columns(tables),
            TDatabase.from_columns(tables, device="cpu"))


def both_queries(atoms, prob_var=None):
    ref = JoinQuery(tuple(Atom.of(r, *vs, alias=al) for r, vs, al in atoms),
                    prob_var=prob_var)
    port = TJoinQuery(tuple(TAtom.of(r, *vs, alias=al) for r, vs, al in atoms),
                      prob_var=prob_var)
    return ref, port


def _rng_col(rng, hi, n):
    return rng.integers(0, hi, n)


def shapes():
    """(tables, atoms, prob_var) cases mirroring tests/test_shred_probe.py:
    chain, star with a path, self join, the paper's Fig. 2, empty child and
    root relations, a cross product, bag duplicates, a deep chain, and a
    three-way random chain."""
    cases = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        a, b, c = (_rng_col(rng, 5, 8) for _ in range(3))
        cases.append(({"R": {"x": a, "y": b}, "S": {"y": b[::-1], "z": c}},
                      [("R", ("x", "y"), None), ("S", ("y", "z"), None)], None))
        n = lambda: int(rng.integers(0, 8))  # noqa: E731
        nf, n1, n2, ne = n(), n(), n(), n()
        cases.append(({
            "F": {"a": _rng_col(rng, 4, nf), "b": _rng_col(rng, 4, nf),
                  "c": _rng_col(rng, 4, nf)},
            "D1": {"a": _rng_col(rng, 4, n1), "x": _rng_col(rng, 4, n1)},
            "D2": {"b": _rng_col(rng, 4, n2), "y": _rng_col(rng, 4, n2)},
            "E": {"y": _rng_col(rng, 4, ne), "w": _rng_col(rng, 4, ne)},
        }, [("F", ("a", "b", "c"), None), ("D1", ("a", "x"), None),
            ("D2", ("b", "y"), None), ("E", ("y", "w"), None)], None))
        g = _rng_col(rng, 4, 7)
        cases.append(({"P": {"u": np.arange(7), "g": g}},
                      [("P", ("u1", "g"), "A"), ("P", ("u2", "g"), "B")], None))
    cases.append(({
        "R": {"x": [1, 1, 2, 2, 3], "y": [1, 2, 1, 2, 3], "p": [1, 2, 3, 4, 5]},
        "S": {"u": [1, 1, 2, 3, 3, 4], "a": [1, 1, 1, 2, 2, 3],
              "x": [1, 2, 1, 1, 3, 2]},
        "T": {"v": [1, 2, 3, 4, 5, 6], "y": [4, 2, 1, 2, 1, 2]},
    }, [("R", ("x", "y", "p"), None), ("S", ("u", "a", "x"), None),
        ("T", ("v", "y"), None)], "p"))
    cases.append(({"R": {"x": [1, 2]}, "S": {"x": [], "z": []}},
                  [("R", ("x",), None), ("S", ("x", "z"), None)], None))
    cases.append(({"R": {"x": []}, "S": {"x": [1], "z": [2]}},
                  [("R", ("x",), None), ("S", ("x", "z"), None)], None))
    cases.append(({"R": {"x": [1, 2]}, "S": {"z": [5, 6, 7]}},
                  [("R", ("x",), None), ("S", ("z",), None)], None))
    cases.append(({"R": {"x": [1, 1], "y": [7, 7]}, "S": {"x": [1, 1, 1]}},
                  [("R", ("x", "y"), None), ("S", ("x",), None)], None))
    cases.append(({
        "A": {"a": [0, 1], "b": [0, 1]}, "B": {"b": [0, 1], "c": [1, 0]},
        "C": {"c": [0, 1], "d": [0, 0]}, "D": {"d": [0], "e": [9]},
    }, [("A", ("a", "b"), None), ("B", ("b", "c"), None),
        ("C", ("c", "d"), None), ("D", ("d", "e"), None)], None))
    rng = np.random.default_rng(0)
    cases.append(({
        "R": {"x": _rng_col(rng, 5, 30), "y": _rng_col(rng, 5, 30)},
        "S": {"y": _rng_col(rng, 5, 25), "z": _rng_col(rng, 5, 25)},
        "T": {"z": _rng_col(rng, 5, 20), "w": _rng_col(rng, 5, 20)},
    }, [("R", ("x", "y"), None), ("S", ("y", "z"), None),
        ("T", ("z", "w"), None)], None))
    return cases


CASES = shapes()


@pytest.mark.parametrize("rep", ["usr", "both", "csr"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_build_shred_matches_reference(case, rep):
    tables, atoms, prob_var = CASES[case]
    rdb, tdb = both_dbs(tables)
    rq, tq = both_queries(atoms, prob_var)
    want = ref_arrays(build_shred(rdb, rq, rep=rep))
    got = ref_arrays(t_build_shred(tdb, tq, rep=rep))
    assert_same(want, got)


def test_shred_from_arrays_round_trip():
    for tables, atoms, prob_var in CASES:
        rdb, _ = both_dbs(tables)
        rq, _ = both_queries(atoms, prob_var)
        want = ref_arrays(build_shred(rdb, rq, rep="both"))
        assert_same(want, ref_arrays(shred_from_arrays(want, device="cpu")))


def test_dense_keys_match_reference():
    from repro.core import dense_keys

    rng = np.random.default_rng(3)
    for ncols in (1, 2, 3):
        left = [rng.integers(-3, 4, 40) for _ in range(ncols)]
        right = [rng.integers(-3, 4, 25) for _ in range(ncols)]
        want = dense_keys([np.asarray(c) for c in left],
                          [np.asarray(c) for c in right])
        got = t_dense_keys([torch.as_tensor(c) for c in left],
                           [torch.as_tensor(c) for c in right])
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
            assert g.dtype == torch.int64


def test_arena_limit_refuses_packing():
    tables, atoms, prob_var = CASES[-1]
    _, tdb = both_dbs(tables)
    _, tq = both_queries(atoms, prob_var)
    full = t_build_shred(tdb, tq)
    assert full.packed is not None
    small = KernelPolicy(arena_limit=full.packed.layout.size - 1)
    assert t_build_shred(tdb, tq, policy=small).packed is None


def test_csr_is_not_ported():
    """The name is historical: rep 'csr' is ported now. A CSR index carries
    the successor chains and the USR arrays the arena packs (as in the
    reference), and an unknown rep still raises."""
    tables, atoms, prob_var = CASES[0]
    _, tdb = both_dbs(tables)
    _, tq = both_queries(atoms, prob_var)
    shred = t_build_shred(tdb, tq, rep="csr")
    child = shred.root.children[0]
    assert child.nxt is not None and child.nxt.dtype == torch.int32
    assert child.perm is not None and shred.packed is not None
    assert t_build_shred(tdb, tq, rep="usr").root.children[0].nxt is None
    with pytest.raises(ValueError, match="csr"):
        t_build_shred(tdb, tq, rep="chained")
