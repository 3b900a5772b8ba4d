"""A closed loop of Monte-Carlo workers over the micro-batcher.

Each of ``clients`` workers submits one Poisson draw of the query under
its own seed through ``MicroBatcher.submit`` and waits for it; the
batcher flushes at ``max_batch`` requests or after ``max_wait_ms``
(``poll``). With ``update_every`` set, an ``UpdateRequest`` follows every
that many completed draws (``drivers/churn.py``). Latencies run from the
submit to the call that returned the request, on the benchmark's clock.
"""
from __future__ import annotations

import time
from typing import List, Optional

from portbench.lib.window import EngineProxy, Reservoir, Window


def run(ctx, updates: Optional[List[object]] = None) -> Window:
    from repro_torch.launch.fleet.batcher import (JoinSampleRequest,
                                                  MicroBatcher, UpdateRequest)

    spec = ctx.spec
    engine = ctx.engine_factory(ctx.db)
    with ctx.rec.span("compile"):
        engine.compile(ctx.query)
    ctx.sync()
    ctx.stamp("index built")
    ctx.describe(engine)
    base = int(ctx.rng.integers(1 << 40, 1 << 62))
    res = Reservoir(spec["check_batches"], ctx.rng, ctx.meter)
    proxy = EngineProxy(engine, ctx.rec,
                        keep=lambda smp, v: res.offer((v, smp)))
    mb = MicroBatcher(proxy, max_batch=spec["max_batch"],
                      max_wait_ms=spec["max_wait_ms"])
    flush = mb.flush

    def timed_flush():
        with ctx.rec.span("flush"):
            return flush()

    mb.flush = timed_flush
    win = Window()
    state = {"seed": base, "draws": 0, "updates": 0}
    every = spec.get("update_every")

    def loop(stop) -> None:
        clients = spec["clients"]
        idle, out = clients, {}

        def handle(done) -> None:
            nonlocal idle
            now = time.perf_counter()
            for r in done:
                if isinstance(r, UpdateRequest):
                    continue
                win.done("draw", now - out.pop(id(r)))
                idle += 1
                state["draws"] += 1
                if every and state["draws"] % every == 0:
                    update()
            if done:
                ctx.tracer.maybe_stop()

        def update() -> None:
            delta = updates[state["updates"] % len(updates)]
            state["updates"] += 1
            t0 = time.perf_counter()
            req = UpdateRequest(delta)
            handle([r for r in mb.submit(req) if r is not req])
            ctx.sync()
            win.done("update", time.perf_counter() - t0)
            ctx.applied.append((req.applied_version, delta))

        while True:
            while idle and not stop():
                r = JoinSampleRequest(ctx.query, seed=state["seed"])
                state["seed"] += 1
                idle -= 1
                out[id(r)] = time.perf_counter()
                handle(mb.submit(r))
            handle(mb.poll())
            if stop():
                handle(mb.flush())
                if not out:
                    return

    n_warm = spec["warm_batches"]
    loop(lambda: mb.flushes >= n_warm)
    res.restart(spec["check_batches"], ctx.check_rng)
    before = engine.stats.snapshot()
    counts0 = (mb.flushes, mb.dispatches, mb.served)
    ctx.open_window(win)
    t_end = win.t_open + ctx.seconds
    loop(lambda: time.perf_counter() >= t_end)
    ctx.close_window(win)
    after = engine.stats.snapshot()
    win.counters = {"stats_before": before, "stats_after": after,
                    "flushes": mb.flushes - counts0[0],
                    "dispatches": mb.dispatches - counts0[1],
                    "served": mb.served - counts0[2]}
    win.kept["draws"] = list(res.items)
    if updates:
        win.kept["final_tables"] = {rel: dict(obj.columns) for rel, obj in
                                    engine.db.relations.items()}
    return win
