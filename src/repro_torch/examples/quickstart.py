"""Quickstart: one engine, one index — full joins and Poisson samples; the
port of the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the card by default; ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.config import resolve_device
from repro_torch.core import Atom, Database, JoinQuery
from repro_torch.engine import QueryEngine
from repro_torch.kernels import threefry

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' runs the "
                         "plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    # A tiny movie database: every (title, actor, company) combination of a
    # title is a join tuple; each title carries its own probability p.
    db = Database.from_columns({
        "Title": {"t": [0, 1, 2, 3], "p": [0.9, 0.5, 0.1, 0.7]},
        "Cast": {"t": [0, 0, 1, 1, 1, 2, 3],
                 "actor": [10, 11, 12, 13, 14, 15, 16]},
        "Comp": {"t": [0, 1, 1, 2, 3, 3],
                 "comp": [100, 101, 102, 103, 104, 105]},
    }, device=dev)
    query = JoinQuery(
        (Atom.of("Title", "t", "p"), Atom.of("Cast", "t", "actor"),
         Atom.of("Comp", "t", "comp")),
        prob_var="p",
    )
    # One engine binds the database; the first call on a query plans (GYO)
    # and builds the shred index; every call after it is served from the
    # compiled-plan cache.
    engine = QueryEngine(db, device=dev)
    size = engine.join_size(query)
    print(f"full join size |Q(db)| = {size} (never materialized)")
    # Independent Poisson samples, one a step (O(k log |db|) each).
    samples = []
    for step in range(3):
        s = engine.poisson_sample(query, threefry.key(step))
        k = int(s.count)
        rows = list(zip(*(s.columns[c][:k].tolist()
                          for c in ("t", "actor", "comp", "p"))))
        samples.append(rows)
        print(f"step {step}: k={k} sample={rows}")
    # The same cached index computes the full join (Yannakakis).
    full = engine.full_join(query)
    n_full = len(next(iter(full.values())))
    print("full join tuples:", n_full)
    print(engine.explain(query))
    return {"join_size": size, "full_join_rows": n_full, "samples": samples}


if __name__ == "__main__":
    main()
