"""Time the search, scan and draw wrappers of two checkouts of the port on
one card.

    PYTHONPATH=src python3 -m repro_torch.kernels.ab --parent DIR \\
        [--reps N] [--smoke] [--json-out FILE]

DIR is a second checkout of the repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory. Each checkout
runs in a process of its own, in the order DIR, this, this, DIR. A process
builds its checkout's kernels, builds the index of ``chip_smoke.py``'s
configuration A (JOB's 2,528,312 titles) from the same seed, makes phase
D's inputs from the same seeds, and calls its own wrappers on them:

  * ``bsearch_probe`` over A's int32 root prefix: ``chip_smoke.py``'s
    sorted queries (A's arrival capacity), and the same queries shuffled;
  * ``ops.geo_positions_fused`` at p = 0.05 over A's join (phase D's
    lanes, Threefry uniforms of key 4000);
  * ``ops.prefix_sum`` of phase D's int32 weights (Cast's 36,244,344
    rows);
  * ``tree_probe`` over A's arena at every position of the join;
  * A's warm Poisson draw through the engine (the per-node route, whose
    int32 searches take ``bsearch_probe``), 10 calls. Its checksum is
    reported per run, with whether five draws of one key in one process
    agree, and not held across runs;
  * ``fused_draw`` at B's shapes and ``fused_sample`` at C's (32,000 and
    60,000 titles), one key each: single launches of the draw kernel.
    Their checksums are reported per run and not held across runs either:
    the float32 tables come from a float64 mass prefix whose summation
    order may differ between checkouts.

With ``--smoke`` the tool times the whole of each checkout's
``python3 chip_smoke.py`` instead (run from the checkout's root, kernel
builds included, wall seconds from start to exit, in the same order), and
writes each run's output to ``--json-out``'s directory as
``smoke_<n>_<label>.log``; a run that fails stops the tool.

Every result is held against the plain version first, and its checksum
against the other runs'. Each checkout's ``-Xptxas -v`` lines of
``bsearch_probe``, ``scan``, ``tree_get`` and ``fused_draw`` are printed
once. ``ms`` is the mean of ``--reps`` warm wrapper
calls by CUDA events (timed before any profiler session of the process);
``device_ms`` and ``ops`` are the device busy time and the device
operations (kernels, memsets) of a call by ``torch.profiler``. Needs one
CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
SEED = 0
GEO_P, GEO_KEY, Z_LIMIT = 0.05, 4000, 6.0  # chip_smoke.py's phase D
SCAN_N = 36_244_344
PTXAS = ("bsearch_probe", "scan", "tree_get", "fused_draw")


def child(tree: Path, reps: int) -> dict:
    """One checkout's times, in this process (``tree``'s package; the
    data from this checkout's ``chip_smoke.py``)."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.core import Atom, Database, JoinQuery
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import bsearch_probe as bp
    from repro_torch.kernels import build, ops, threefry
    from repro_torch.kernels import geo_gaps as geo
    from repro_torch.kernels import prefix_sum as ps
    from repro_torch.kernels import tree_probe as tp

    assert Path(tp.__file__).resolve().is_relative_to(tree.resolve())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build.build_all()
    q = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                   Atom.of("Cast", "t", "person"),
                   Atom.of("Comp", "t", "comp")), prob_var="p")
    engine = QueryEngine(Database.from_columns(
        chip_smoke.make_tables(SEED, chip_smoke.IMDB_TITLE), device=device),
        device=device)
    plan = engine.compile(q)
    pack, n = plan.shred.packed, plan.join_size
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    pref = plan.prefE.to(torch.int32)
    qs = torch.sort(torch.randint(0, n + 1, (plan.arrival_capacity(),),
                                  generator=gen, device=device,
                                  dtype=torch.int32)).values
    shuffled = qs[torch.randperm(qs.numel(), generator=gen, device=device)]
    mean = n * GEO_P
    lanes = math.ceil((mean + Z_LIMIT * math.sqrt(mean * (1 - GEO_P)))
                      / 128) * 128
    u = threefry.uniforms(threefry.key(GEO_KEY), lanes, 0, device)
    w = torch.randint(0, 59, (SCAN_N,), generator=gen, device=device,
                      dtype=torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=device)
    cases = {
        "bsearch_probe A sorted": (
            qs, lambda: bp.bsearch_probe(pref, qs),
            lambda: bp.bsearch_probe_plain(pref, qs)),
        "bsearch_probe A shuffled": (
            shuffled, lambda: bp.bsearch_probe(pref, shuffled),
            lambda: bp.bsearch_probe_plain(pref, shuffled)),
        "geo_positions_fused D": (
            u, lambda: ops.geo_positions_fused(u, GEO_P),
            lambda: geo.geo_gaps_plain(u, GEO_P)),
        "prefix_sum int32 D": (
            w, lambda: ops.prefix_sum(w), lambda: ps.prefix_sum_plain(w)),
        "tree_probe A": (
            pos, lambda: tp.tree_probe(pack.arena, pos, pack.layout),
            lambda: tp.tree_probe_plain(pack.arena, pos, pack.layout)),
    }
    out = {}
    for name, (inp, fn, plain) in cases.items():
        got = fn()
        assert torch.equal(got, plain()), name
        out[name] = {"inputs": inp.numel(),
                     "input_sum": int(inp.view(torch.int32).sum(
                         dtype=torch.int64)),
                     "output_sum": int(got.sum(dtype=torch.int64)),
                     "ms": chip_smoke.timed(fn, reps, device)}
        del got
    key = threefry.key(7)
    cases["sample A"] = (None, lambda: engine.sample(q, key), None)
    smp, *again = (engine.sample(q, key) for _ in range(5))
    assert plan.route == "pernode" and not bool(smp.overflow)
    out["sample A"] = {
        "inputs": plan.arrival_capacity(), "input_sum": 0,
        "output_sum": int(smp.positions[:int(smp.count)].sum()),
        "count": int(smp.count),
        "repeat_equal": all(torch.equal(smp.positions, a.positions)
                            for a in again),
        "ms": chip_smoke.timed(cases["sample A"][1], 10, device)}
    del smp, again
    from repro_torch.kernels import fused_draw as fd

    for name, seed, titles, walk in (("fused_draw B", SEED + 1, 32_000, True),
                                     ("fused_sample C", SEED + 2, 60_000,
                                      False)):
        eng = QueryEngine(Database.from_columns(
            chip_smoke.make_tables(seed, titles), device=device),
            device=device)
        pl = eng.compile(q)
        kw = dict(method="exprace", cap=pl.default_capacity(),
                  acap=pl.arrival_capacity())
        arena, layout = pl.shred.packed.arena, pl.shred.packed.layout
        if walk:
            fn = (lambda a=arena, lay=layout, p=pl.draw_params, k=kw:
                  fd.fused_draw(a, key, p, layout=lay, **k))
            want = fd.fused_draw_plain(arena, key, pl.draw_params,
                                       layout=layout, **kw)
        else:
            fn = (lambda p=pl.draw_params, k=kw: fd.fused_sample(key, p, **k))
            want = fd.fused_sample_plain(key, pl.draw_params, **kw)
        got = fn()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
        cases[name] = (None, fn, None)
        out[name] = {"inputs": kw["acap"], "input_sum": 0,
                     "output_sum": int(got[-3].sum(dtype=torch.int64)),
                     "count": int(got[-2]),
                     "ms": chip_smoke.timed(fn, reps, device)}
    for name, (_, fn, _) in cases.items():
        out[name]["device_ms"], out[name]["ops"] = chip_smoke.device_ms(
            fn, 5 if name == "sample A" else 20)
    return out, {src: chip_smoke.ptxas_lines(build.ptxas_report(src))
                 for src in PTXAS}


def smoke(other: Path, log_dir: Path) -> list:
    """Wall seconds of each checkout's whole ``chip_smoke.py`` run, in
    the order DIR, this, this, DIR."""
    log_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    for n, (label, tree) in enumerate((("parent", other), ("this", ROOT),
                                       ("this", ROOT), ("parent", other))):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                           capture_output=True, text=True, timeout=1200)
        seconds = time.perf_counter() - t0
        (log_dir / f"smoke_{n}_{label}.log").write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            raise SystemExit(r.returncode)
        print(f"[smoke] {label} ({tree}): chip_smoke.py {seconds:.1f} s; "
              f"last line {r.stdout.strip().splitlines()[-1]}", flush=True)
        runs.append((label, seconds))
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="time each checkout's whole chip_smoke.py")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(Path(args.child), args.reps)))
        return 0
    other = Path(args.parent).resolve()
    if not (other / "src" / "repro_torch").is_dir():
        print(f"ab: {other} holds no port", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    if args.smoke:
        out = Path(args.json_out or "chiprun_out/smoke.json").resolve()
        runs = smoke(other, out.parent)
        out.write_text(json.dumps({"device": smi, "smoke_s": runs},
                                  indent=1))
        return 0
    runs, reports = [], {}
    for label, tree in (("parent", other), ("this", ROOT), ("this", ROOT),
                        ("parent", other)):
        # -P: the script's own directory stays off sys.path, so that the
        # child imports the package of the checkout it times
        r = subprocess.run(
            [sys.executable, "-P", str(Path(__file__).resolve()),
             "--parent", str(other), "--reps", str(args.reps),
             "--child", str(tree)], capture_output=True, text=True,
            timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        times, ptxas = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append((label, times))
        if label not in reports:
            reports[label] = ptxas
            for src, lines in ptxas.items():
                for entry, line in lines:
                    print(f"[ptxas] {label} {src}: {entry}: {line}",
                          flush=True)
    for name in runs[0][1]:
        sums = [(r[name]["input_sum"], r[name]["output_sum"])
                for _, r in runs]
        if "count" in runs[0][1][name]:
            line = f"{name}: (count, position sum) " + " | ".join(
                f"{lb} ({r[name]['count']}, {r[name]['output_sum']})"
                for lb, r in runs)
            if "repeat_equal" in runs[0][1][name]:
                line += "; repeats of one key in one process equal: " + \
                    " | ".join(f"{lb} {r[name]['repeat_equal']}"
                               for lb, r in runs)
            print(line, flush=True)
        else:
            assert len(set(sums)) == 1, (name, sums)

        def row(key, fmt):
            return " | ".join(f"{lb} {format(r[name][key], fmt)}"
                              for lb, r in runs)

        print(f"{name} ({runs[0][1][name]['inputs']} inputs): ms "
              f"{row('ms', '.4f')}; device ms {row('device_ms', '.4f')}; "
              f"device operations a call {row('ops', 'g')}", flush=True)
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": smi, "runs": runs,
                                   "ptxas": reports}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
