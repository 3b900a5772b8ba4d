#!/usr/bin/env python3
"""Time the USR GET of two checkouts of the PyTorch/CUDA port on one card.

    python3 tools/tree_get_ab.py OTHER [--reps N] [--json-out FILE]

OTHER is a second checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a git-ignored directory. Each
checkout runs in a process of its own, in the order OTHER, this, this,
OTHER. A process builds its checkout's kernels, builds the indexes of
``chip_smoke.py``'s configurations A (2,528,312 titles) and C (60,000
titles) from the same seeds, and times its own wrappers on the same
probes:

  * ``tree_probe`` over A's arena: all 37.4 M positions in order, a
    per-node sample of them (sorted), and all of them shuffled;
  * ``tree_probe`` over C's arena: all positions, and one paged draw's
    positions (``fused_sample``, sentinels clamped as ``draw_paged`` does);
  * ``tree_probe_paged`` over C's pages at that draw: the default
    (``dma=None``), the stacked form (``dma=True``), the per-page form
    (``dma=False``).

Every result is held against ``tree_probe_plain`` first. ``ms`` is the mean
of ``--reps`` warm wrapper calls by CUDA events; ``device_ms`` the device
busy time of a call by ``torch.profiler`` (every kernel the call runs).
The inputs' and outputs' checksums show that both checkouts walked the
same probes to the same rows. Needs one CUDA card; imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def _device_ms(fn, reps: int) -> float:
    """Device busy milliseconds of one call of ``fn`` (mean of ``reps``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / reps


def child(tree: Path, reps: int) -> dict:
    """One checkout's times, in this process (``tree``'s package)."""
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.core import Atom, Database, JoinQuery, PagedArena
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import build, threefry
    from repro_torch.kernels import fused_draw as fd
    from repro_torch.kernels import tree_probe as tp

    assert Path(tp.__file__).resolve().is_relative_to(tree.resolve())
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    build.build_all()
    q = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                   Atom.of("Cast", "t", "person"),
                   Atom.of("Comp", "t", "comp")), prob_var="p")
    plans = {}
    for label, n_t, seed in (("A", chip_smoke.IMDB_TITLE, SEED),
                             ("C", 60_000, SEED + 2)):
        engine = QueryEngine(Database.from_columns(
            chip_smoke.make_tables(seed, n_t), device=device), device=device)
        plans[label] = (engine, engine.compile(q))
    engA, planA = plans["A"]
    _, planC = plans["C"]
    packA, packC = planA.shred.packed, planC.shred.packed
    nA, nC = planA.join_size, planC.join_size
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    posA = torch.arange(nA, dtype=torch.int32, device=device)
    shuffled = posA[torch.randperm(nA, generator=gen, device=device)]
    smp = engA.sample(q, threefry.key(999))
    sampleA = smp.positions[:int(smp.count)].to(torch.int32)
    del smp
    posC = torch.arange(nC, dtype=torch.int32, device=device)
    posS = torch.clamp(fd.fused_sample(
        threefry.key(SEED + 2), planC.draw_params, method="exprace",
        cap=planC.default_capacity(), acap=planC.arrival_capacity())[0],
        max=nC - 1)
    pvC = PagedArena.from_packed(packC)

    def get_A(p):
        return tp.tree_probe(packA.arena, p, packA.layout)

    def get_C(p):
        return tp.tree_probe(packC.arena, p, packC.layout)

    cases = {
        "A all": (packA, posA, get_A),
        "A per-node sample": (packA, sampleA, get_A),
        "A shuffled": (packA, shuffled, get_A),
        "C all": (packC, posC, get_C),
        "C draw": (packC, posS, get_C),
        "C draw, paged default": (packC, posS,
                                  lambda p: tp.tree_probe_paged(pvC, p)),
        "C draw, paged dma=True": (packC, posS, lambda p: tp.tree_probe_paged(
            pvC, p, dma=True)),
        "C draw, paged dma=False": (packC, posS, lambda p: tp.tree_probe_paged(
            pvC, p, dma=False)),
    }
    out = {}
    for name, (pack, pos, fn) in cases.items():
        want = tp.tree_probe_plain(pack.arena, pos, pack.layout)
        got = fn(pos)
        assert torch.equal(got, want), name
        out[name] = {
            "probes": pos.numel(),
            "ms": chip_smoke.timed(lambda: fn(pos), reps, device),
            "device_ms": _device_ms(lambda: fn(pos), reps),
            "probe_sum": int(pos.sum(dtype=torch.int64)),
            "row_sum": int(got.sum(dtype=torch.int64))}
        del want, got
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(Path(args.child), args.reps)))
        return 0
    other = Path(args.other).resolve()
    if not (other / "src" / "repro_torch").is_dir():
        print(f"tree_get_ab: {other} holds no port", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    runs = []
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        r = subprocess.run(
            [sys.executable, __file__, str(other), "--reps", str(args.reps),
             "--child", str(tree)], capture_output=True, text=True,
            timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        runs.append((label, json.loads(r.stdout.strip().splitlines()[-1])))
    for name in runs[0][1]:
        sums = {(r[name]["probe_sum"], r[name]["row_sum"]) for _, r in runs}
        assert len(sums) == 1, (name, sums)
        print(f"{name} ({runs[0][1][name]['probes']} probes): ms "
              + " | ".join(f"{lb} {r[name]['ms']:.4f}" for lb, r in runs)
              + "; device ms "
              + " | ".join(f"{lb} {r[name]['device_ms']:.4f}"
                           for lb, r in runs), flush=True)
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": smi, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
