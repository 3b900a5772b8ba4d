"""``drivers/draws.py``'s closed loop with an update after every
``update_every`` draws: a churn of ``frac`` of ``relation``'s rows each
way (that many rows deleted, as many inserted, resampled from the
relation as generated, so keys stay in distribution and the row count is
kept). ``delta_pool`` such deltas are made in set-up from the seed and
taken in turn: a delete names row indices, so each applies to any
snapshot of the relation's size."""
from __future__ import annotations

from portbench.drivers import draws


def run(ctx):
    from repro_torch.core.delta import DeltaBatch

    upd = ctx.spec["update"]
    cols = ctx.tables[upd["relation"]]
    n = next(iter(cols.values())).shape[0]
    k = max(1, int(upd["frac"] * n))
    pool = []
    for _ in range(upd["delta_pool"]):
        spec = {upd["relation"]: {
            "delete": ctx.rng.choice(n, k, replace=False),
            "insert": {c: v[ctx.rng.integers(0, n, k)]
                       for c, v in cols.items()}}}
        pool.append((spec, DeltaBatch.of(**spec)))
    ctx.delta_specs = {id(d): s for s, d in pool}
    return draws.run(ctx, updates=[d for _, d in pool])
