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
  * ``prefix_sum_tiles`` over A's 2,528,312 float64 masses (the per-node
    draw's mass prefix) and over 36,244,344 float32 uniforms (phase D's
    float32 scan at Cast's rows), with ``torch.cumsum`` of the same input
    beside each;
  * A's warm Poisson draw through the engine (the per-node route, whose
    int32 searches take ``bsearch_probe``), 10 calls. Its checksum is
    reported per run, with whether five draws of one key in one process
    agree, and not held across runs;
  * ``fused_draw`` at B's shapes and ``fused_sample`` at C's (32,000 and
    60,000 titles), one key each, and ``fused_draw_batch`` at B and
    ``fused_sample_batch`` at C with 32 keys each: single and batched
    launches of the draw kernel, each held against its plain version, with
    the kernel's phase clock (``fused_draw.phase_ms``, the mean of 10
    launches).
  * ``csr_walk_cached`` and ``csr_walk`` over the CSR index of A on both
    edges, at the sorted positions of the draw above and at every
    position of the join (``chip_smoke.csr_walks``'s operands), each
    held against the uncached walk's rows and offsets. Their checksums are reported per run and not held across
    runs either: the float32 tables come from a float64 mass prefix whose
    summation order may differ between checkouts;
  * the upload of the 32 keys of the batched draw (``fused_draw.
    _device_keys``), and a ``MicroBatcher`` flush of 32 draws of the
    three-way join at B (``chip_smoke.py``'s serving profile, 32 requests
    at ``max_batch`` 32): their ``ms`` is host time, the mean of ``--reps``
    calls, each started on an idle card after a synchronize (a flush ends
    in its host read of the counts), so the flush's draws a second are
    32,000 / ms.

With ``--smoke`` the tool times the whole of each checkout's
``python3 chip_smoke.py`` instead (run from the checkout's root, kernel
builds included, wall seconds from start to exit, in the same order), and
writes each run's output to ``--json-out``'s directory as
``smoke_<n>_<label>.log``; a run that fails stops the tool.

Every result is held against the plain version first, and its checksum
against the other runs'. Each checkout's ``-Xptxas -v`` lines of
``bsearch_probe``, ``scan``, ``tree_get``, ``fused_draw`` and
``csr_walk`` are printed once. ``ms`` is the mean of ``--reps`` warm wrapper
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
BATCH = 32  # keys of the batched draws (a batcher flush)
PTXAS = ("bsearch_probe", "scan", "tree_get", "fused_draw", "csr_walk")


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
    # A's mass prefix (sampling.mass_prefix's float64 masses, as
    # chip_smoke.py phase E makes them), and phase D's float32 scan at
    # Cast's rows (uniforms, as its "float32 random"), with torch.cumsum
    # beside each
    pA = torch.clamp(plan.p.double(), 0.0, 1.0)
    xA = plan.w.double() * -torch.log1p(-torch.clamp(
        torch.where(pA > 0.5, 1.0 - pA, pA), max=0.5))
    genf = torch.Generator(device=device)
    genf.manual_seed(SEED + 1)
    wf = torch.rand((SCAN_N,), generator=genf, device=device)
    for label, x in (("float64 A", xA), ("float32 D", wf)):
        got = ps.prefix_sum_tiles(x)
        assert torch.equal(got, ps.prefix_sum_plain(x)), label
        for name, fn in (
                (f"prefix_sum {label}", lambda x=x: ps.prefix_sum_tiles(x)),
                (f"torch.cumsum {label}", lambda x=x: torch.cumsum(x, 0))):
            cases[name] = (None, fn, None)
            out[name] = {"inputs": x.numel(), "input_sum": 0,
                         "output_sum": int(got[-1]) if "prefix" in name
                         else 0,
                         "ms": chip_smoke.timed(fn, reps, device)}
        del got
    key = threefry.key(7)
    cases["sample A"] = (None, lambda: engine.sample(q, key), None)
    smp, *again = (engine.sample(q, key) for _ in range(5))
    assert plan.route == "pernode" and not bool(smp.overflow)
    # The CSR walks at A: both kernels at the sorted positions of this
    # draw (both edges) and over the full join, each held against the
    # other on every edge
    from repro_torch.core import probe
    from repro_torch.kernels import csr_walk as cw

    shred = QueryEngine(engine.db, rep="csr", device=device).compile(q).shred
    pol = engine.kernel_policy
    every = torch.arange(n, dtype=torch.int64, device=device)
    drawn = torch.clamp(smp.positions[:int(smp.count)], max=n - 1)
    walks = {"draw": chip_smoke.csr_walks(probe, cw, shred, drawn, pol),
             "full join": chip_smoke.csr_walks(probe, cw, shred, every, pol)}
    for label, edges in walks.items():
        for wname, fn in (("csr_walk_cached", cw.csr_walk_cached),
                          ("csr_walk", cw.csr_walk)):
            def call(fn=fn, edges=edges):
                return [fn(e.child.weight, e.child.nxt, e.hd, e.idx)
                        for e in edges]
            got = call()
            for e, (row, rem) in zip(edges, got):
                assert torch.equal(row, e.row) and torch.equal(rem, e.rem)
            name = f"{wname} A {label} (both edges)"
            cases[name] = (None, call, None)
            out[name] = {"inputs": sum(e.hd.numel() for e in edges),
                         "input_sum": int(sum(e.idx.sum() for e in edges)),
                         "output_sum": int(sum(r.sum(dtype=torch.int64)
                                               for r, _ in got)),
                         "ms": chip_smoke.timed(call, reps, device)}
            del got
    out["sample A"] = {
        "inputs": plan.arrival_capacity(), "input_sum": 0,
        "output_sum": int(smp.positions[:int(smp.count)].sum()),
        "count": int(smp.count),
        "repeat_equal": all(torch.equal(smp.positions, a.positions)
                            for a in again),
        "ms": chip_smoke.timed(cases["sample A"][1], 10, device)}
    del smp, again
    from repro_torch.kernels import fused_draw as fd

    keys = threefry.keys(2000, BATCH)
    for label, seed, titles, walk in (("B", SEED + 1, 32_000, True),
                                      ("C", SEED + 2, 60_000, False)):
        eng = QueryEngine(Database.from_columns(
            chip_smoke.make_tables(seed, titles), device=device),
            device=device)
        pl = eng.compile(q)
        kw = dict(method="exprace", cap=pl.default_capacity(),
                  acap=pl.arrival_capacity())
        prm = pl.draw_params
        arena, layout = pl.shred.packed.arena, pl.shred.packed.layout
        # defaults bind this configuration's operands: the calls run again
        # after the loop, for their device times
        if walk:
            runs = {
                f"fused_draw {label}": (
                    lambda a=arena, p=prm, lay=layout, k=kw:
                    fd.fused_draw(a, key, p, layout=lay, **k),
                    lambda a=arena, p=prm, lay=layout, k=kw:
                    fd.fused_draw_plain(a, key, p, layout=lay, **k),
                    dict(arena=arena, key=key, layout=layout)),
                f"fused_draw_batch {label} {BATCH}": (
                    lambda a=arena, p=prm, lay=layout, k=kw:
                    fd.fused_draw_batch(a, keys, p, layout=lay, **k),
                    lambda a=arena, p=prm, lay=layout, k=kw:
                    fd.fused_draw_batch_plain(a, keys, p, layout=lay, **k),
                    dict(arena=arena, key=None, layout=layout, keys=keys))}
        else:
            runs = {
                f"fused_sample {label}": (
                    lambda p=prm, k=kw: fd.fused_sample(key, p, **k),
                    lambda p=prm, k=kw: fd.fused_sample_plain(key, p, **k),
                    dict(arena=None, key=key)),
                f"fused_sample_batch {label} {BATCH}": (
                    lambda p=prm, k=kw: fd.fused_sample_batch(keys, p, **k),
                    lambda p=prm, k=kw: fd.fused_sample_batch_plain(keys, p,
                                                                    **k),
                    dict(arena=None, key=None, keys=keys))}
        if walk:
            engB = eng
        for name, (fn, plain, pk) in runs.items():
            got = fn()
            assert all(torch.equal(g, w) for g, w in zip(got, plain())), name
            cases[name] = (None, fn, None)
            clock = [fd.phase_ms(params=prm, **pk, **kw)
                     for _ in range(11)][1:]
            out[name] = {"inputs": kw["acap"], "input_sum": 0,
                         "output_sum": int(got[-3].sum(dtype=torch.int64)),
                         "count": int(got[-2].sum()),
                         "ms": chip_smoke.timed(fn, reps, device),
                         "phases": {k: sum(c[k] for c in clock) / len(clock)
                                    for k in clock[0]}}
    from repro_torch.launch.fleet import JoinSampleRequest, MicroBatcher

    def host_ms(fn):
        fn()
        total = 0.0
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            total += time.perf_counter() - t0
        torch.cuda.synchronize()
        return total * 1e3 / reps

    def flush():
        mb = MicroBatcher(engB, max_batch=BATCH, max_wait_ms=1e9)
        done = []
        for i in range(BATCH):
            done += mb.submit(JoinSampleRequest(query=q, seed=7000 + i))
        return done
    served = [r.count for r in flush()]
    assert len(served) == BATCH
    uploads = {
        f"key upload {BATCH}": lambda: fd._device_keys(keys, device),
        f"batcher flush B {BATCH}": flush}
    for name, fn in uploads.items():
        cases[name] = (None, fn, None)
        out[name] = {"inputs": BATCH, "input_sum": 0, "output_sum": 0,
                     "ms": host_ms(fn)}
    out[f"batcher flush B {BATCH}"].update(
        count=int(sum(served)), output_sum=int(sum(served)))
    for name, (_, fn, _) in cases.items():
        out[name]["device_ms"], out[name]["ops"] = chip_smoke.device_ms(
            fn, 5 if name.startswith(("sample A", "batcher", "csr_walk"))
            else 20)
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
        if name.startswith("batcher"):
            print("  draws a second " + " | ".join(
                f"{lb} {BATCH * 1e3 / r[name]['ms']:.1f}" for lb, r in runs)
                + "; device idle share of the flush " + " | ".join(
                f"{lb} {1 - r[name]['device_ms'] / r[name]['ms']:.3f}"
                for lb, r in runs), flush=True)
        for lb, r in runs:
            if "phases" in r[name]:
                ph = r[name]["phases"]
                print(f"  {lb} phases (ms, mean of 10): total "
                      f"{sum(ph.values()):.4f}; " + ", ".join(
                          f"{k} {v:.4f}" for k, v in ph.items()), flush=True)
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": smi, "runs": runs,
                                   "ptxas": reports}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
