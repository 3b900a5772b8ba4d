"""A closed loop of one analyst running ad hoc full joins.

Each request builds a fresh ``QueryEngine`` over the resident tables,
compiles the query (the index build) and enumerates the full join; the
analyst waits for the rows on the card before the next request.
"""
from __future__ import annotations

import time

from portbench.lib.window import Reservoir, Window


def run(ctx) -> Window:
    spec = ctx.spec
    win = Window()
    res = Reservoir(spec["check_joins"], ctx.rng, ctx.meter)

    def request() -> float:
        t0 = time.perf_counter()
        with ctx.rec.span("request"):
            engine = ctx.engine_factory(ctx.db)
            with ctx.rec.span("compile"):
                engine.compile(ctx.query)
            with ctx.rec.span("full_join"):
                full = engine.full_join(ctx.query)
            ctx.sync()
        res.offer(full)
        ctx.describe(engine)
        return time.perf_counter() - t0

    for _ in range(spec["warm_joins"]):
        request()
    res.restart(spec["check_joins"], ctx.check_rng)
    ctx.open_window(win)
    t_end = win.t_open + ctx.seconds
    while time.perf_counter() < t_end:
        win.done("join", request())
        ctx.tracer.maybe_stop()
    ctx.close_window(win)
    win.kept["joins"] = list(res.items)
    return win
