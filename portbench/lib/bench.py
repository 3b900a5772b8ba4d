"""One run of one cell: set-up, the window, the judge, the readers, and
the result line.

``main`` is the command's entry: it refuses to run without the cards the
cell asks for. ``run_cell`` is the rest of a run on any device, which the
CPU tests drive at a small ``scale`` (and with a broken or lower-precision
engine in the program's place, through ``engine_factory``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from portbench.lib import judge, manifest
from portbench.lib.trace import Trace, Tracer, own_kernels
from portbench.metrics import _yardstick as ys
from portbench.lib.window import PeakMeter, Recorder

# the JAX package and JAX itself, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# numbers the judge reports beside the compared ones
INFO = ("draws_checked", "joins_checked", "updates_checked",
        "count_dev_per_draw")


def seed_words(seed: int, *tags: int) -> np.random.Generator:
    """A generator of its own for each purpose, all from ``--seed``."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), *tags]))


class Ctx:
    """What a driver is handed: the program's inputs, the engine factory,
    the recorder, the tracer, and the window's bounds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.applied = []     # (version, DeltaBatch) of every update
        self.delta_specs = {}  # id(DeltaBatch) -> the spec it was made from
        self.plan = {}

    def open_window(self, win) -> None:
        self.sync()
        self.stamp("warmed up")
        self.tracer.start()   # before the window: starting takes a while
        win.t_open = time.perf_counter()
        win.open = self.rec.recording = True

    def close_window(self, win) -> None:
        self.tracer.stop()
        self.sync()
        win.open = self.rec.recording = False
        win.t_close = time.perf_counter()

    def describe(self, engine) -> None:
        """The plan the program chose, once (for the run's log)."""
        if self.plan or not hasattr(engine, "explain"):
            return
        plan = engine.compile(self.query)
        self.plan = {"route": plan.route, "join": plan.join_size,
                     "expected_k": plan.expected_k(),
                     "cap": plan.default_capacity()}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, *, root: Path = manifest.ROOT,
             scale: float = 1.0, spec_overrides: Optional[dict] = None,
             engine_factory: Optional[Callable] = None,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)
             ) -> Dict[str, object]:
    import torch

    from repro_torch.core import Atom, Database, JoinQuery
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import build

    man = manifest.load(root)
    r = manifest.resolve(man, cell, root)
    spec = dict(r["spec"], **(spec_overrides or {}))
    config = r["config"]
    on_card = device.type == "cuda"
    def stamp(what: str) -> None:
        log(f"[setup] {what} at {time.perf_counter() - t_start:.2f} s")

    stamp("program imported")
    if on_card:
        build.build_all(build.SOURCES)
        stamp("kernels built")
    tables = manifest.load_module(r["gen"]).make(
        config, int(seed_words(seed, 0).integers(1 << 62)), scale)
    stamp("tables made")
    db = Database.from_columns(tables, device=device)
    query = JoinQuery(tuple(Atom.of(rel, *vs) for rel, vs in
                            config["query"]["atoms"]),
                      prob_var=config["query"]["prob_var"])

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sync()
    stamp(f"tables on {device}")
    rec = Recorder(traced, sync)
    tracer = Tracer(traced, spec["trace_seconds"], rec, device)
    if engine_factory:
        factory = engine_factory(tables, config, device)
    else:
        def factory(d):
            return QueryEngine(d, device=device)
    meter = PeakMeter(device)
    ctx = Ctx(spec=spec, config=config, tables=tables, db=db, query=query,
              device=device, sync=sync, rec=rec, tracer=tracer,
              engine_factory=factory, seconds=seconds,
              rng=seed_words(seed, 1), check_rng=seed_words(seed, 2),
              stamp=stamp, meter=meter)
    meter.start()
    driver = manifest.load_module(r["driver"])
    win = driver.run(ctx)
    setup_s = win.t_open - t_start
    # the program's peak, without the outputs kept for the judge
    meter.mark(meter.held)
    peak = meter.peak
    log(f"[window] {win.seconds:.3f} s; "
        + ", ".join(f"{k} {len(v)}" for k, v in win.latencies.items())
        + f"; plan {ctx.plan}; memory peak {peak} B, {meter.with_kept} B"
        " with the kept outputs")

    # The program's state goes before the reference runs; only its
    # outputs stay, for the judge.
    counters = dict(win.counters)
    kept = win.kept
    applied = [(v, ctx.delta_specs[id(d)]) for v, d in ctx.applied]
    first_version = db.version
    del ctx, db
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = manifest.load_module(r["reference"])
    atoms = config["query"]["atoms"]
    ref_tables = {rel: {c: torch.as_tensor(v).to(device) for c, v in
                        cols.items()} for rel, cols in tables.items()}
    snapshots = {first_version: ref_tables}
    stars = {}

    def tables_at(v: int):
        if v not in snapshots:
            k = max(u for u in snapshots if u < v)
            snap = snapshots[k]
            for ver, spec_d in applied:
                if k < ver <= v:
                    snap = ref.apply_delta(snap, spec_d)
            snapshots.clear()
            snapshots[v] = snap
        return snapshots[v]

    def star_at(v: int):
        if v not in stars:
            stars.clear()
            stars[v] = ref.Star(tables_at(v), atoms,
                                config["query"]["prob_var"])
        return stars[v]

    checks: Dict[str, float] = {}
    if "draws" in kept:
        checks.update(judge.draws(sorted(kept["draws"], key=lambda x: x[0]),
                                  star_at))
    if "joins" in kept:
        checks.update(judge.joins(kept["joins"], star_at(first_version)))
    if applied:
        last = max(v for v, _ in applied)
        checks.update(judge.snapshot(kept["final_tables"], tables_at(last),
                                     [v for v, _ in applied],
                                     first_version + 1))
    star0 = star_at(first_version) if not applied else ref.Star(
        ref_tables, atoms, config["query"]["prob_var"])
    root_rel = atoms[0][0]
    sizes = {"relations": [len(next(iter(tables[a[0]].values())))
                           for a in atoms],
             "roots": len(next(iter(tables[root_rel].values()))),
             "children": [len(next(iter(tables[a[0]].values())))
                          for a in atoms[1:]],
             "join": star0.size,
             "get_search_steps": ys.get_search_steps(
                 len(star0.w), star0.w, star0.key_degrees()),
             "arrivals": float((star0.w.to(torch.float64)
                                * -torch.log1p(-star0.p)).sum()),
             "expected_k": star0.expected_k()}
    del kept, stars, snapshots, star0, ref_tables
    log(f"[check] reference and comparison in {time.perf_counter() - t0:.1f}"
        f" s; join {sizes['join']}, E[k] {sizes['expected_k']:.1f}")

    limits = spec["limits"]
    compared = {k: v for k, v in checks.items() if k not in INFO}
    missing = sorted(set(compared) - set(limits))
    if missing:
        raise KeyError(f"{cell}: no limit for {missing}")
    correct = all(compared[k] <= limits[k] for k in compared)

    metrics: Dict[str, dict] = {}
    units = r["units"]
    if traced:
        trace = Trace(rec, counters, sizes, tracer,
                      own_kernels(Path(build.CSRC)))
        for name, path in r["per_layer"].items():
            v = manifest.load_module(path).read(trace)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        for name, path in r["end_to_end"].items():
            v = manifest.load_module(path).read(win)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    attempted = sum(len(v) for v in win.latencies.values())
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if traced and trace.traced:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        out["breakdown"] = trace.breakdown()
    out["checks"] = {k: {"value": float(v), "limit": float(limits[k])}
                     for k, v in compared.items()}
    out["checked"] = {k: checks[k] for k in INFO if k in checks}
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest.load()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " here", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"the process loaded {found}", file=sys.stderr)
        return 3
    checked = out.pop("checked")
    print(f"[checked] {json.dumps(checked)}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"[correct] {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
