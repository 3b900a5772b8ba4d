"""EpiQL-style epidemic simulation (the paper's motivating application,
Example 1.1), the port of the reference's ``examples/epiql_contact_sim.py``:
a discrete SIR model where each day's contact events are an independent
Poisson sample of

    Q_c = beta_prob( Person(per1,age1,pool) |><| Person(per2,age2,pool)
                     |><| ContactProb(pool,age1,age2,prob) )

The contact join (~|pools| x pool_size^2 tuples) is never materialized:
the index is built once and each day probes it. Day ``d`` draws under
``threefry.fold_in(key(42), d)`` (``jax.random.fold_in``, as the
reference folds its key); the initial infections and the transmission
coins come from explicit ``torch.Generator``s, and the disease state
lives on the sampler's device.

    PYTHONPATH=src python -m repro_torch.examples.epiql_contact_sim \\
        [--pop 3000] [--days 20] [--device cpu]

It runs on the card by default; ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import resolve_device
from repro_torch.core import Atom, Database, JoinQuery, estimate
from repro_torch.engine import QueryEngine
from repro_torch.kernels import threefry

__all__ = ["build_population", "simulate", "main"]


def build_population(pop: int, pools: int, ages: int, seed: int,
                     device=None):
    """The population and the contact probabilities (the reference's
    tables, from the same numpy stream) on ``device``, and the contact
    query."""
    rng = np.random.default_rng(seed)
    grid = [(g, a1, a2) for g in range(pools) for a1 in range(ages)
            for a2 in range(ages)]
    # diary-study-like contact probabilities, mean ~2.4% (paper section 6.2)
    probs = np.clip(rng.gamma(2.0, 0.012, len(grid)), 0, 1)
    db = Database.from_columns({
        "Person": {"pers": np.arange(pop), "age": rng.integers(0, ages, pop),
                   "pool": rng.integers(0, pools, pop)},
        "ContactProb": {"pool": [g for g, _, _ in grid],
                        "age1": [a for _, a, _ in grid],
                        "age2": [a for _, _, a in grid],
                        "prob": probs},
    }, device=device)
    q = JoinQuery((
        Atom.of("ContactProb", "pool", "age1", "age2", "prob"),
        Atom.of("Person", "per1", "age1", "pool", alias="P1"),
        Atom.of("Person", "per2", "age2", "pool", alias="P2"),
    ), prob_var="prob")
    return db, q


def simulate(pop: int = 3000, pools: int = 75, ages: int = 6,
             days: int = 20, seeds: int = 5, p_transmit: float = 0.35,
             days_infectious: int = 4, *, device=None,
             verbose: bool = False) -> Dict:
    """Run the simulation; returns the contact join's size, its expected
    contacts a day and their standard deviation, each day's ``(day,
    contacts, new infections, milliseconds)`` (the day's draw and update,
    ended by a device synchronize) and the final attack rate."""
    dev = resolve_device(device)
    db, q = build_population(pop, pools, ages, seed=0, device=dev)
    sampler = QueryEngine(db, device=dev).compile(q)  # built once
    gen = torch.Generator(device=dev).manual_seed(1)
    # disease state: 0 = S, > 0 infectious days left, -1 = recovered
    state = torch.zeros(pop, dtype=torch.int32, device=dev)
    first = torch.randperm(pop, generator=gen, device=dev)[:seeds]
    state[first] = days_infectious
    key = threefry.key(42)
    history: List = []
    for day in range(days):
        t0 = time.perf_counter()
        contacts = sampler.sample(threefry.fold_in(key, day))
        k = int(contacts.count)
        p1 = contacts.columns["per1"][:k].long()
        p2 = contacts.columns["per2"][:k].long()
        s1, s2 = state[p1], state[p2]
        coin = torch.rand(k, generator=gen, device=dev) < p_transmit
        # transmission: S meets I
        newly = torch.unique(torch.cat([p2[(s1 > 0) & (s2 == 0) & coin],
                                        p1[(s2 > 0) & (s1 == 0) & coin]]))
        # disease clocks: I ticks down; expiring -> recovered (-1)
        ticking = state > 0
        state[ticking] -= 1
        state[ticking & (state == 0)] = -1
        newly = newly[state[newly] == 0]  # only susceptibles get infected
        state[newly] = days_infectious
        counts = torch.stack([(state == 0).sum(), (state > 0).sum(),
                              (state < 0).sum()]).tolist()
        ms = (time.perf_counter() - t0) * 1e3
        history.append((day, k, int(newly.numel()), ms))
        if verbose:
            print(f"day {day:3d}: contacts={k:6d} new_infections="
                  f"{int(newly.numel()):5d} S={counts[0]:5d} I={counts[1]:5d} "
                  f"R={counts[2]:5d} ({ms:.2f} ms)")
    attack = (pop - int((state == 0).sum())) / pop
    return {"join_size": sampler.join_size,
            "expected_k": sampler.expected_k(),
            "sd_k": float(estimate.sample_std(sampler.w, sampler.p)),
            "route": sampler.route,
            "days": history, "attack_rate": attack}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pop", type=int, default=3000)
    ap.add_argument("--pools", type=int, default=75)
    ap.add_argument("--ages", type=int, default=6)
    ap.add_argument("--days", type=int, default=20)
    ap.add_argument("--seeds", type=int, default=5, help="initially infected")
    ap.add_argument("--p-transmit", type=float, default=0.35)
    ap.add_argument("--days-infectious", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="where it runs (default: the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"population={args.pop} on {dev}")
    out = simulate(args.pop, args.pools, args.ages, args.days, args.seeds,
                   args.p_transmit, args.days_infectious, device=dev,
                   verbose=True)
    print(f"contact-join size={out['join_size']:,} (never materialized)  "
          f"E[contacts/day]={out['expected_k']:.0f}  draw route "
          f"{out['route']}")
    print(f"attack rate: {out['attack_rate']:.1%}")
    return out


if __name__ == "__main__":
    main()
