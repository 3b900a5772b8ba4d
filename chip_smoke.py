#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path through its entry points at JOB scale: the
index build, the full join through the ``tree_probe`` kernel, Poisson
sampling through the per-node route (``bsearch_probe`` + ``tree_probe``),
through the one-launch ``fused_draw`` kernel, and through the paged draw
(``fused_sample`` + ``tree_probe_paged``). It builds every kernel from
``src/repro_torch/kernels/csrc/``, holds each against its plain PyTorch
version on the card, checks the join against an independent numpy
expansion and the samples against the join and their expected size, and
times each kernel beside its bound.

Data (numpy, from ``--seed``): the schema and probabilities of
``benchmarks/workloads.py`` ``job_like`` (Title(t, kind, p) |><|
Cast(t, person) |><| Comp(t, comp), p ~ Beta(2, 10), keys uniform), at the
cardinalities of the Join Order Benchmark's IMDB tables ``title``,
``cast_info`` and ``movie_companies`` (Leis et al., VLDB 2015):

  A  job-imdb          2,528,312 titles — arena over the fused draw's
                       budget, so ``sample`` takes the per-node route;
  B  job-imdb-serving  32,000 titles, the same ratios — arena within the
                       budget, so ``sample`` takes the fused draw.
  C  job-imdb-paged    60,000 titles, the same ratios — arena over the
                       fused draw's budget but every page within it, so
                       ``sample`` takes the paged draw (as the reference
                       routes it); the full IMDB arena is over the paged
                       rung's own ceiling.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one. The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel's
launches, agreement and times; the line before that is the card's name and
power limit as ``nvidia-smi`` reports them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# IMDB row counts (JOB): title, cast_info, movie_companies.
IMDB_TITLE, IMDB_CAST, IMDB_COMP = 2_528_312, 36_244_344, 2_609_129
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 rate outside the tensor cores
Z_LIMIT = 6.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def make_tables(seed: int, n_t: int):
    """job_like's schema at JOB's IMDB ratios, from numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_c = round(n_t * IMDB_CAST / IMDB_TITLE)
    n_m = round(n_t * IMDB_COMP / IMDB_TITLE)
    return {
        "Title": {"t": np.arange(n_t), "kind": rng.integers(0, 7, n_t),
                  "p": rng.beta(2, 10, n_t)},
        "Cast": {"t": rng.integers(0, n_t, n_c),
                 "person": rng.integers(0, 2 * n_t, n_c)},
        "Comp": {"t": rng.integers(0, n_t, n_m),
                 "comp": rng.integers(0, 50, n_m)},
    }


def expand_numpy(tables):
    """The full join in the canonical flatten order, by numpy alone: titles
    in row order; per title its Cast rows in stable key order; per Cast row
    its Comp rows in stable key order (the join tree is Title -> Cast ->
    Comp). Title's ``t`` is its row id."""
    import numpy as np

    title, cast, comp = tables["Title"], tables["Cast"], tables["Comp"]
    n_t = title["t"].shape[0]
    cast_ord = np.argsort(cast["t"], kind="stable")
    comp_ord = np.argsort(comp["t"], kind="stable")
    b = np.bincount(comp["t"], minlength=n_t)
    comp_start = np.cumsum(b) - b
    ct = cast["t"][cast_ord]
    bt = b[ct]
    rep_t = np.repeat(ct, bt)
    cast_rows = np.repeat(cast_ord, bt)
    j = np.arange(rep_t.shape[0]) - np.repeat(np.cumsum(bt) - bt, bt)
    comp_rows = comp_ord[comp_start[rep_t] + j]
    return {"t": title["t"][rep_t], "kind": title["kind"][rep_t],
            "p": title["p"][rep_t], "person": cast["person"][cast_rows],
            "comp": comp["comp"][comp_rows]}


def timed(fn, reps: int, device) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up:
    CUDA events on the card, the host clock elsewhere."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def wall_ms(fn, device) -> float:
    """Host milliseconds of one warm call that ends in a synchronize."""
    import torch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    return (time.perf_counter() - t0) * 1e3


def profile_window(fn, label: str, wall_ms_unprofiled: float) -> dict:
    """Device time by kernel over one warm call of ``fn`` (torch.profiler;
    device-side events only), and the device's idle share of the call's
    unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda k: -k[1])
    busy_ms = sum(t for _, t, _ in kernels) / 1e3
    idle = 1 - busy_ms / wall_ms_unprofiled
    log(f"[profile] {label}: device busy {busy_ms:.3f} ms of "
        f"{wall_ms_unprofiled:.3f} ms warm wall, idle share {idle:.3f}")
    for name, t, count in kernels[:8]:
        log(f"[profile] {label}:   {t / 1e3:8.3f} ms  x{count:<3d} {name[:80]}")
    return {"busy_ms": busy_ms, "idle_share": idle,
            "top": [(name, t / 1e3, count) for name, t, count in kernels[:8]]}


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b) -> float:
    import torch

    if a.numel() == 0:
        return 0.0
    return float(torch.max(torch.abs(a.double() - b.double())))


def check_join(full, tables, label: str) -> None:
    import numpy as np

    want = expand_numpy(tables)
    assert set(full) == set(want), (label, sorted(full), sorted(want))
    for v, col in want.items():
        got = full[v].cpu().numpy()
        assert got.shape == col.shape, (label, v, got.shape, col.shape)
        assert np.array_equal(got, col), (label, v)
    log(f"[{label}] full_join equals the numpy expansion: "
        f"{col.shape[0]} rows x {len(want)} columns")


def check_sample(smp, full, label: str) -> int:
    import torch

    c = int(smp.count)
    assert not bool(smp.overflow), label
    pos = smp.positions[:c]
    assert bool((pos[1:] > pos[:-1]).all()), label
    for v, col in full.items():
        assert torch.equal(smp.columns[v][:c], col[pos]), (label, v)
    return c


def walk_ops(layout, steps_for) -> int:
    """Operations of one tree walk: 6 per descent step, 12 per edge."""
    ops = 6 * steps_for(layout.root_len)
    for e in layout.edges:
        ops += 6 * steps_for(e.n_child + 1) + 12
    return ops


def run(args, device, kernel_policy=None) -> dict:
    """Every phase after the device check; ``main`` passes the card.
    (On the CPU, with ``KernelPolicy(prefer=True)``, the same control flow
    runs the plain versions: a rehearsal, with no launches to count.)"""
    import numpy as np
    import torch

    from repro_torch.config import KernelPolicy
    from repro_torch.core import (Atom, Database, JoinQuery, PagedArena,
                                  estimate, sampling)
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import bsearch_probe as bp_mod
    from repro_torch.kernels import build, fused_draw as fd_mod
    from repro_torch.kernels import threefry
    from repro_torch.kernels import tree_probe as tp_mod

    on_card = device.type == "cuda"
    kernels = {"tree_probe": tp_mod.tree_probe,
               "bsearch_probe": bp_mod.bsearch_probe,
               "fused_draw": fd_mod.fused_draw,
               "fused_sample": fd_mod.fused_sample,
               "tree_probe_paged": tp_mod.tree_probe_paged,
               "tree_probe_paged_dma": tp_mod.tree_probe_paged_dma}
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    # -- 2. build ------------------------------------------------------------
    if on_card:
        t0 = time.perf_counter()
        reports = build.build_all()
        log(f"[build] {len(build.SOURCES)} kernels in "
            f"{time.perf_counter() - t0:.1f} s")
        for name in build.SOURCES:
            text = reports.get(name) or build.ptxas_report(name)
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")

    q = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                   Atom.of("Cast", "t", "person"),
                   Atom.of("Comp", "t", "comp")), prob_var="p")
    configs = {}
    for label, n_t, seed in (("A", args.title_rows, args.seed),
                             ("B", args.serving_title_rows, args.seed + 1),
                             ("C", args.paged_title_rows, args.seed + 2)):
        t0 = time.perf_counter()
        tables = make_tables(seed, n_t)
        engine = QueryEngine(Database.from_columns(tables, device=device),
                             device=device, kernel_policy=kernel_policy)
        plan = engine.compile(q)
        if on_card:
            torch.cuda.synchronize()
        lay = plan.shred.packed.layout
        log(f"[{label}] Title {n_t}, Cast {tables['Cast']['t'].shape[0]}, "
            f"Comp {tables['Comp']['t'].shape[0]}: join {plan.join_size}, "
            f"arena {lay.size} int32, tree {' -> '.join(lay.names)}, "
            f"E[k] {plan.expected_k():.1f}, cap {plan.default_capacity()}, "
            f"acap {plan.arrival_capacity()}, route {plan.route}; data and "
            f"index in {time.perf_counter() - t0:.1f} s")
        configs[label] = (tables, engine, plan)
    tabA, engA, planA = configs["A"]
    tabB, engB, planB = configs["B"]
    tabC, engC, planC = configs["C"]
    assert planA.route == "pernode" and planA.rep_default == "usr_fused"
    assert planB.route == "fused" and planB.rep_default == "usr_fused"
    assert planC.route == "paged" and planC.rep_default == "usr_fused"

    # -- 3. kernels against their plain versions, at the main path's shapes
    errs = {}
    packA = planA.shred.packed
    nA = planA.join_size
    posA = torch.arange(nA, dtype=torch.int32, device=device)
    got = tp_mod.tree_probe(packA.arena, posA, packA.layout)
    want = tp_mod.tree_probe_plain(packA.arena, posA, packA.layout)
    errs["tree_probe"] = max_abs_err(got, want)
    del got, want
    prefA = planA.prefE.to(torch.int32)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    qA = torch.sort(torch.randint(0, nA + 1, (planA.arrival_capacity(),),
                                  generator=gen, device=device,
                                  dtype=torch.int32)).values
    errs["bsearch_probe"] = max_abs_err(bp_mod.bsearch_probe(prefA, qA),
                                        bp_mod.bsearch_probe_plain(prefA, qA))
    packB = planB.shred.packed
    capB, acapB = planB.default_capacity(), planB.arrival_capacity()
    keyB = threefry.key(args.seed)
    kw = dict(layout=packB.layout, method="exprace", cap=capB, acap=acapB)
    got = fd_mod.fused_draw(packB.arena, keyB, planB.draw_params, **kw)
    want = fd_mod.fused_draw_plain(packB.arena, keyB, planB.draw_params, **kw)
    errs["fused_draw"] = max(max_abs_err(g, w) for g, w in zip(got, want))
    # Off the main path, the same kernel: probabilities at both extremes
    # (the complement inversion, p = 0 and p = 1) and flat PTBERN.
    rng = np.random.default_rng(args.seed)
    p_mix = torch.as_tensor(rng.choice(
        [0.0, 0.02, 0.3, 0.5, 0.7, 0.98, 1.0], planB.w.numel())).to(device)
    mixed = sampling.fused_draw_params(planB.w, p_mix, planB.prefE)
    kw_mix = dict(layout=packB.layout, method="exprace",
                  cap=engB.policy.sample_capacity(planB.w, p_mix),
                  acap=engB.policy.arrival_capacity(planB.w, p_mix))
    kw_pt = dict(layout=packB.layout, method="ptbern_flat", cap=capB,
                 n=planB.join_size)
    for params, kwx in ((mixed, kw_mix), (planB.draw_params, kw_pt)):
        got = fd_mod.fused_draw(packB.arena, keyB, params, **kwx)
        want = fd_mod.fused_draw_plain(packB.arena, keyB, params, **kwx)
        assert not bool(got[3]), kwx["method"]
        errs["fused_draw"] = max(errs["fused_draw"], *(
            max_abs_err(g, w) for g, w in zip(got, want)))
    # The paged rung's kernels at C's shapes. fused_sample: EXPRACE, the
    # extreme-p mix and flat PTBERN (n = the join, within draw_limit).
    packC = planC.shred.packed
    pvC = PagedArena.from_packed(packC)
    nC, capC, acapC = planC.join_size, planC.default_capacity(), \
        planC.arrival_capacity()
    keyC = threefry.key(args.seed + 2)
    p_mixC = torch.as_tensor(rng.choice(
        [0.0, 0.02, 0.3, 0.5, 0.7, 0.98, 1.0], planC.w.numel())).to(device)
    mixedC = sampling.fused_draw_params(planC.w, p_mixC, planC.prefE)
    errs["fused_sample"] = 0.0
    for params, kwx in (
            (planC.draw_params, dict(method="exprace", cap=capC,
                                     acap=acapC)),
            (mixedC, dict(method="exprace",
                          cap=engC.policy.sample_capacity(planC.w, p_mixC),
                          acap=engC.policy.arrival_capacity(planC.w,
                                                            p_mixC))),
            (planC.draw_params, dict(method="ptbern_flat", cap=capC,
                                     n=nC))):
        got = fd_mod.fused_sample(keyC, params, **kwx)
        want = fd_mod.fused_sample_plain(keyC, params, **kwx)
        assert not bool(got[2]), kwx
        errs["fused_sample"] = max(errs["fused_sample"], *(
            max_abs_err(g, w) for g, w in zip(got, want)))
        # The same positions, count and overflow as the fused draw's.
        for run_draw in (fd_mod.fused_draw, fd_mod.fused_draw_plain):
            full = run_draw(packC.arena, keyC, params, layout=packC.layout,
                            **kwx)
            for g, f in zip(got, full[1:]):
                assert torch.equal(g, f), (kwx, run_draw.__name__)
    log(f"[check] fused_sample at C: positions, count and overflow equal "
        f"fused_draw's (kernel and plain) for EXPRACE, the extreme-p mix "
        f"and flat PTBERN")
    # tree_probe_paged, both forms, over every position of C.
    posC = torch.arange(nC, dtype=torch.int32, device=device)
    want = tp_mod.tree_probe_plain(packC.arena, posC, packC.layout)
    errs["tree_probe_paged"] = max_abs_err(
        tp_mod.tree_probe_paged(pvC, posC), want)
    errs["tree_probe_paged_dma"] = max_abs_err(
        tp_mod.tree_probe_paged(pvC, posC, dma=True), want)
    del want
    u_dev = threefry.uniforms(keyB, acapB, 0, device)
    u_plain = threefry.uniforms_plain(keyB, acapB, 0, device)
    errs["threefry"] = max_abs_err(u_dev, u_plain)
    for name, err in errs.items():
        log(f"[check] {name}: kernel vs plain max_abs_err {err}")
        assert err == 0.0, name

    # torch.poisson at the per-node route's rate (M ~ Poisson(Lam)).
    lamA = float(estimate.exprace_arrival_mass(planA.w, planA.p))
    m = torch.poisson(torch.full((20000,), lamA, dtype=torch.float64,
                                 device=device), generator=gen)
    z_mean = (float(m.mean()) - lamA) / math.sqrt(lamA / m.numel())
    var_ratio = float(m.var()) / lamA
    log(f"[check] torch.poisson at rate {lamA:.1f}: mean z {z_mean:+.2f}, "
        f"var/rate {var_ratio:.4f}")
    assert abs(z_mean) < Z_LIMIT and abs(var_ratio - 1) < 0.06

    launches = {}

    # -- 4. config A: the main path, per-node route ----------------------------
    for fn in kernels.values():
        fn.launches = 0
    fullA = engA.full_join(q)
    zs = []
    mean, sd = planA.expected_k(), float(estimate.sample_std(planA.w, planA.p))
    for s in range(args.keys):
        smp = engA.sample(q, threefry.key(1000 + s))
        zs.append((check_sample(smp, fullA, "A") - mean) / sd)
    launchesA = {k: fn.launches for k, fn in kernels.items()}
    log(f"[A] launches {launchesA}")
    if on_card:
        assert launchesA["tree_probe"] > 0 and launchesA["bsearch_probe"] > 0
        assert launchesA["fused_draw"] == 0
    log(f"[A] sample counts z vs E[k]={mean:.1f} sd={sd:.1f}: "
        + ", ".join(f"{z:+.2f}" for z in zs))
    assert all(abs(z) < Z_LIMIT for z in zs)
    check_join(fullA, tabA, "A")
    assert (engA.stats.shred_builds, engA.stats.plan_misses) == (1, 1), engA.stats
    log(f"[A] cache {engA.stats}")

    # -- 5. config B: the main path, fused route -------------------------------
    for fn in kernels.values():
        fn.launches = 0
    fullB = engB.full_join(q)
    counts = [check_sample(engB.sample(q, threefry.key(2000 + s)), fullB, "B")
              for s in range(args.draws)]
    launchesB = {k: fn.launches for k, fn in kernels.items()}
    log(f"[B] launches {launchesB}")
    if on_card:
        assert launchesB["fused_draw"] == args.draws
        assert launchesB["tree_probe"] > 0
    meanB = planB.expected_k()
    sdB = float(estimate.sample_std(planB.w, planB.p))
    zB = (float(np.mean(counts)) - meanB) / (sdB / math.sqrt(len(counts)))
    log(f"[B] {len(counts)} draws: mean count {np.mean(counts):.1f} vs "
        f"E[k] {meanB:.1f}, z {zB:+.2f}")
    assert abs(zB) < Z_LIMIT
    check_join(fullB, tabB, "B")
    assert (engB.stats.shred_builds, engB.stats.plan_misses) == (1, 1), engB.stats

    # -- 5b. config C: the main path, paged draw ----------------------------
    for fn in kernels.values():
        fn.launches = 0
    fullC = engC.full_join(q)
    counts = [check_sample(engC.sample(q, threefry.key(3000 + s)), fullC, "C")
              for s in range(args.draws)]
    launchesC = {k: fn.launches for k, fn in kernels.items()}
    log(f"[C] launches {launchesC}")
    if on_card:
        assert launchesC["fused_sample"] == args.draws
        assert launchesC["tree_probe_paged"] == (
            args.draws * (1 + len(packC.layout.edges)))
        assert launchesC["fused_draw"] == 0 and launchesC["tree_probe"] > 0
    meanC = planC.expected_k()
    sdC = float(estimate.sample_std(planC.w, planC.p))
    zC = (float(np.mean(counts)) - meanC) / (sdC / math.sqrt(len(counts)))
    log(f"[C] {len(counts)} draws: mean count {np.mean(counts):.1f} vs "
        f"E[k] {meanC:.1f}, z {zC:+.2f}")
    assert abs(zC) < Z_LIMIT
    check_join(fullC, tabC, "C")
    assert (engC.stats.shred_builds, engC.stats.plan_misses) == (1, 1), engC.stats

    # -- 5c. config C under the reference's single budget (the draw budget,
    # 2^21, for the arena too): the index pages at build and the GET takes
    # the paged rung, as in the reference. Its draws are held against C's.
    keysR = [threefry.key(3000 + s) for s in range(2)]
    wantR = [engC.sample(q, key) for key in keysR]
    for fn in kernels.values():
        fn.launches = 0
    pol = kernel_policy or KernelPolicy()
    engR = QueryEngine(engC.db, device=device,
                       kernel_policy=dataclasses.replace(
                           pol, arena_limit=pol.draw_limit))
    planR = engR.compile(q)
    assert planR.shred.packed is None and planR.shred.paged is not None
    assert planR.route == "paged" and planR.rep_default == "usr_paged"
    fullR = engR.full_join(q)
    for key, b in zip(keysR, wantR):
        a = engR.sample(q, key)
        assert torch.equal(a.positions, b.positions)
        for v in a.columns:
            assert torch.equal(a.columns[v], b.columns[v]), v
    launchesR = {k: fn.launches for k, fn in kernels.items()}
    for v, col in fullC.items():
        assert torch.equal(fullR[v], col), v
    log(f"[C, arena_limit={pol.draw_limit}] paged index (pages "
        f"{[e - s for s, e in planR.shred.paged.layout.page_bounds()]}), "
        f"GET {planR.rep_default}, draw {planR.route}: full join and "
        f"{len(keysR)} draws equal C's; launches {launchesR}")
    if on_card:
        assert launchesR["tree_probe"] == 0 and launchesR["fused_draw"] == 0
        assert launchesR["fused_sample"] == len(keysR)
        assert launchesR["tree_probe_paged"] == (1 + len(keysR)) * (
            1 + len(packC.layout.edges))
    for k in kernels:
        launches[k] = launchesA[k] + launchesB[k] + launchesC[k] + launchesR[k]

    # -- 6. times --------------------------------------------------------------
    steps = bp_mod.steps_for
    reps = args.reps
    rows = []
    ms = timed(lambda: tp_mod.tree_probe(packA.arena, posA, packA.layout),
               reps, device)
    plain_ms = timed(lambda: tp_mod.tree_probe_plain(packA.arena, posA,
                                                     packA.layout), 1, device)
    b_ms, b_by = bound(4 * (packA.layout.size + nA * (1 + packA.layout.num_slots)),
                       nA * walk_ops(packA.layout, steps))
    rows.append(("tree_probe", "src/repro/kernels/tree_probe.py:111",
                 ms, plain_ms, b_ms, b_by, None))
    ms = timed(lambda: bp_mod.bsearch_probe(prefA, qA), reps, device)
    plain_ms = timed(lambda: bp_mod.bsearch_probe_plain(prefA, qA), 1, device)
    lib_ms = timed(lambda: torch.searchsorted(prefA, qA, right=True) - 1,
                   reps, device)
    b_ms, b_by = bound(4 * (prefA.numel() + 2 * qA.numel()),
                       qA.numel() * 6 * steps(prefA.numel()))
    rows.append(("bsearch_probe", "src/repro/kernels/bsearch_probe.py:43",
                 ms, plain_ms, b_ms, b_by, lib_ms))
    ms = timed(lambda: fd_mod.fused_draw(packB.arena, keyB, planB.draw_params,
                                         **kw), reps, device)
    plain_ms = timed(lambda: fd_mod.fused_draw_plain(
        packB.arena, keyB, planB.draw_params, **kw), 1, device)
    RB = planB.w.numel()
    draw_bytes = 4 * (packB.layout.size + 7 * (RB + 1)
                      + capB * (packB.layout.num_slots + 1) + 2)
    s_acap, s_R = steps(acapB + 1), steps(RB + 2)
    draw_ops = (acapB * (150 + 6 * 2 * s_R + 40)
                + (RB + 1) * 6 * s_acap
                + capB * (6 * (s_R + 2 * s_acap) + 30
                          + walk_ops(packB.layout, steps)))
    b_ms, b_by = bound(draw_bytes, draw_ops)
    rows.append(("fused_draw", "src/repro/kernels/fused_draw.py:212",
                 ms, plain_ms, b_ms, b_by, None))
    # fused_sample at C's main-path shapes: the draw without the walk.
    kwC = dict(method="exprace", cap=capC, acap=acapC)
    ms = timed(lambda: fd_mod.fused_sample(keyC, planC.draw_params, **kwC),
               reps, device)
    plain_ms = timed(lambda: fd_mod.fused_sample_plain(
        keyC, planC.draw_params, **kwC), 1, device)
    RC = planC.w.numel()
    s_acap, s_R = steps(acapC + 1), steps(RC + 2)
    b_ms, b_by = bound(4 * (7 * (RC + 1) + capC + 2),
                       acapC * (150 + 6 * 2 * s_R + 40)
                       + (RC + 1) * 6 * s_acap
                       + capC * (6 * (s_R + 2 * s_acap) + 30))
    rows.append(("fused_sample", "src/repro/kernels/fused_draw.py:261",
                 ms, plain_ms, b_ms, b_by, None))
    # tree_probe_paged, both forms, at the paged draw's shape: one draw's
    # positions, sentinels clamped as draw_paged clamps them.
    posS = torch.clamp(fd_mod.fused_sample(keyC, planC.draw_params, **kwC)[0],
                       max=nC - 1)
    lay = packC.layout
    b_ms, b_by = bound(4 * (lay.size + capC * (1 + lay.num_slots)),
                       capC * walk_ops(lay, steps))
    for name, dma, replaces in (
            ("tree_probe_paged", None, "src/repro/kernels/tree_probe.py:195"),
            ("tree_probe_paged_dma", True,
             "src/repro/kernels/tree_probe.py:274")):
        ms = timed(lambda: tp_mod.tree_probe_paged(pvC, posS, dma=dma), reps,
                   device)
        plain_ms = timed(lambda: tp_mod.tree_probe_paged_plain(
            pvC, posS, dma=bool(dma)), 1, device)
        rows.append((name, replaces, ms, plain_ms, b_ms, b_by, None))
    # Both forms and the monolithic walk over the whole join of C (the
    # paged GET's shape), side by side.
    get_ms = {
        "per-page": timed(lambda: tp_mod.tree_probe_paged(pvC, posC), reps,
                          device),
        "one-launch": timed(lambda: tp_mod.tree_probe_paged(pvC, posC,
                                                            dma=True),
                            reps, device),
        "tree_probe": timed(lambda: tp_mod.tree_probe(packC.arena, posC, lay),
                            reps, device)}
    log(f"[time] walks of all {nC} positions of C (ms): {get_ms}")

    sources = {"fused_sample": "fused_draw.cu",
               "tree_probe_paged_dma": "tree_probe_paged.cu"}
    table = []
    for name, replaces, ms, plain_ms, b_ms, b_by, lib_ms in rows:
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      + sources.get(name, f"{name}.cu"),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        log(f"[time] {name}: {ms:.4f} ms (plain {plain_ms:.3f}, bound "
            f"{b_ms:.4f} by {b_by}"
            + (f", library {lib_ms:.4f}" if lib_ms is not None else "") + ")")

    e2e = {
        "full_join_A_ms": wall_ms(lambda: engA.full_join(q), device),
        "sample_A_ms": wall_ms(lambda: engA.sample(q, threefry.key(7)), device),
        "sample_B_ms": wall_ms(lambda: engB.sample(q, threefry.key(7)), device),
        "sample_C_ms": wall_ms(lambda: engC.sample(q, threefry.key(7)), device),
    }
    for k, v in e2e.items():
        log(f"[time] warm {k}: {v:.3f}")
    if on_card and args.profile:
        e2e["profile"] = {
            "full_join_A": profile_window(lambda: engA.full_join(q),
                                          "full_join(A)",
                                          e2e["full_join_A_ms"]),
            "sample_A": profile_window(
                lambda: engA.sample(q, threefry.key(7)), "sample(A)",
                e2e["sample_A_ms"]),
            "sample_B": profile_window(
                lambda: engB.sample(q, threefry.key(7)), "sample(B)",
                e2e["sample_B_ms"]),
            "sample_C": profile_window(
                lambda: engC.sample(q, threefry.key(7)), "sample(C)",
                e2e["sample_C_ms"]),
        }
    if on_card:
        e2e["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(device))
        log(f"[memory] peak device memory {e2e['peak_device_bytes'] / 2**30:.2f} GiB")
    e2e["walks_C_ms"] = get_ms
    return {"kernels": table, "end_to_end": e2e,
            "sizes": {k: {"join": c[2].join_size,
                          "arena": c[2].shred.packed.layout.size,
                          "cap": c[2].default_capacity(),
                          "acap": c[2].arrival_capacity(),
                          "expected_k": c[2].expected_k()}
                      for k, c in configs.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--title-rows", type=int, default=IMDB_TITLE,
                    help="Title rows of config A (job-imdb)")
    ap.add_argument("--serving-title-rows", type=int, default=32_000,
                    help="Title rows of config B (job-imdb-serving)")
    ap.add_argument("--paged-title-rows", type=int, default=60_000,
                    help="Title rows of config C (job-imdb-paged)")
    ap.add_argument("--keys", type=int, default=3, help="draws of config A")
    ap.add_argument("--draws", type=int, default=32,
                    help="draws of configs B and C")
    ap.add_argument("--reps", type=int, default=5, help="timed kernel calls")
    ap.add_argument("--profile", action="store_true",
                    help="also break the warm calls down by device kernel")
    ap.add_argument("--json-out", default=None,
                    help="also write the results to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              "repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    smi = nvidia_smi_line()
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    result = run(args, device)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(result, device=smi), indent=1))
    print(smi)
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
