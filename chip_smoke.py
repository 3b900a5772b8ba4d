#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path through its entry points at JOB scale: the
index build, the full join through the GET kernel (``tree_probe``, from
``csrc/tree_get.cu``), Poisson sampling through the per-node route
(``bsearch_probe`` + ``tree_probe``), through the one-launch ``fused_draw``
kernel, and through the paged draw (``fused_sample`` + ``tree_probe_paged``,
one launch of the GET kernel over the pages); then (phase E) batched draws
through ``sample_batch`` on each route (the batched ``fused_draw_batch``
and ``fused_sample_batch`` launches: one a batch), ``uniform_sample``, the
facades (``materialize_and_scan``, ``binary_join``, ``PoissonSampler``) and
the repeats of one key; then (phase D) the kernel-ops
entry point ``repro_torch.kernels.ops``: ``prefix_sum``,
``geo_positions_fused``, ``decode_attention`` and ``prefill_attention``
(the ``scan``, ``flash_decode``, ``flash_prefill`` and
``flash_prefill_tc`` kernels); then (phase F) updates: deltas through
``QueryEngine.apply_delta`` on A's, B's and C's warm engines (the index
merged by ``reshred_incremental`` and held against a rebuild, then the
full join and draws through the upgraded index's kernels, against a
fresh engine), a route flip at B, and the CSR index at A (the
``csr_walk`` kernel in both modes); then (phase G) the serving path and
the data plane: the micro-batcher, a fleet of four replicas with one
crashed, ``serve --mode join`` and the Poisson-join training-data source
over a million-document corpus; then (phase H) sharded sampling on a mesh
of four entries on the card. It builds
every kernel from ``src/repro_torch/kernels/csrc/``, holds each against
its plain PyTorch version on the card (the GET kernel on A's sorted,
shuffled and sampled positions, one probe and a ragged last tile; the
bsearch kernel on A's sorted and shuffled queries, the searches of one
per-node draw, one query, a ragged tile, equal queries and queries past
the prefix, its staged tiles against its plain model's; the paged GET's
three forms at C; the int32 and GEO look-back at each tile size, across
its switch of tile, 150 calls of both and the float64 scan in turn on
one scratch and on a second stream; the float scans bit for bit against
``scan_order``), checks the join against an independent numpy expansion
and the samples against the join and their expected size, and times each
kernel beside its bound: its wrapper by CUDA events, then, after every
timing, its device time by ``torch.profiler``.

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
  E  batches           ``sample_batch`` of 32 keys at B and C, of 6 (padded
                       to 8) at both, of 4 keys at A, every lane held bit
                       for bit against ``sample(keys[b])``; the batched
                       kernels against their plain versions at B and C (1,
                       32 and 64 keys, flat PTBERN); ``uniform_sample`` at A
                       (p = 0.05 and 0.7) and BINOM at B; the facades at B;
                       five per-node draws of one key at A; the float64
                       mass prefix at A against ``torch.cumsum``.
  F  updates           at A, B and C: a churn of 0.5% of Cast each way
                       (``bench_updates.py``'s ``_churn_delta``; 181,221
                       rows each way at A), then new p for 0.5% of the
                       titles with a churn of Comp; at B the fewest Cast
                       inserts that take the arena over ``draw_limit`` and
                       their delete; at A ``full_join`` and ``csr_get_rows``
                       of the CSR index against the USR GET,
                       ``csr_get_rows_cached`` on every position against
                       ``csr_get_rows``, both walk kernels against their
                       plain versions on each edge's operands (the full
                       join's and one draw's) and on a skewed edge (one
                       head of 6,000 rows, its run over many tiles), the
                       caching kernel's staged, fallen-back and one-probe
                       runs against its tile model's; times of
                       ``reshred_incremental`` against ``build_shred`` and
                       of ``apply_delta`` + a draw against ``rebind`` + a
                       draw.
  G  serving           at B's tables (fresh) a stream of 256 draws over
                       three shapes (Title, Title |><| Cast, the three-way
                       join) with four Cast churns: ``serve_join_samples``
                       (max_batch 32, max_wait 2 ms), then
                       ``Fleet(replicas=4, clock='real')`` with the main
                       shape's home crashed mid-stream, each draw against
                       the batcher's per (seed, version); at C 64 draws and
                       at A 16 (max_batch 8, one churn), each against the
                       single draw; ``make_corpus_db`` at 1,000,000
                       documents x 1,024 tokens (4,096 clusters, vocabulary
                       32,000; 8.2 GB of int64 tokens on the card) through
                       ``PoissonJoinSource(batch=32, window=32)`` with two
                       ``corpus_delta`` barriers (1,000 in, 1,000 out at
                       steps 40 and 80), batches 0-127 against a fresh
                       source's in shuffled order and a ``Prefetcher``'s;
                       ``serve.main`` in join mode with 4 replicas. Shrink
                       it with ``--serve-requests``, ``--corpus-docs`` and
                       ``--corpus-seq``.
  H  sharding          a mesh of four entries on the card (four shards of
                       the root): at A (every title) ``full_join(mesh=)``
                       against the single-device join in order, draws
                       against the join and ``expected_k``, warm calls
                       without builds, peak memory; ``apply_delta`` on the
                       sharded plan (a Cast churn, new p for the last
                       block's titles) against a fresh ``build_stacked``;
                       at B (32,000 titles) each shard's draw against one
                       engine's over that shard's database under
                       ``fold_in(key, s)``, a batch of 32 against sharded
                       single draws, ``MicroBatcher(mesh=)`` over phase G's
                       stream, ``serve.main --devices 4``; times beside
                       single-device.
  D  ops               prefix sums over Cast's 36,244,344 weights (int32,
                       inclusive and exclusive; float32; float64), the
                       float scans bit for bit against ``scan_order`` at
                       their tile edges and in five repeats; GEO positions at
                       p = 0.05 over A's join from device Threefry uniforms
                       (8 keys); decode attention at llama3-405b widths
                       (H 128, KV 8, D 128, bf16; decode_32k's S = 32,768,
                       B cut from 128 to 16) under a padding mask, at
                       gemma3-1b widths under its window-512 mask, and in
                       float32; prefill attention at llama3-405b widths
                       (train_4k's S = 4,096, causal and full; prefill_32k's
                       S = 32,768, causal, three heads checked), smollm-135m
                       widths (S = 1,000, ragged, float32 and bf16) and
                       gemma3-1b widths (D = 256, S = 2,048). bf16 attention
                       runs the tensor-core kernels, float32 the CUDA-core
                       ones (timed too).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one. ``--every-card``
instead holds the batched draws on each visible card in turn against their
plain versions (a machine with several cards) and prints ``CARDS {...}``. The last line is
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
BF16_TC_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
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
    Comp). Keys are non-negative integers; a title row joins by its ``t``
    value, wherever the row stands."""
    import numpy as np

    title, cast, comp = tables["Title"], tables["Cast"], tables["Comp"]
    n_key = 1 + max(int(title["t"].max(initial=0)),
                    int(cast["t"].max(initial=0)),
                    int(comp["t"].max(initial=0)))

    def runs(parent_keys, child_keys):
        """(parent index, child row) of every pair, parents in order and
        each parent's child rows in stable key order."""
        order = np.argsort(child_keys, kind="stable")
        count = np.bincount(child_keys, minlength=n_key)
        start = np.cumsum(count) - count
        reps = count[parent_keys]
        parent = np.repeat(np.arange(parent_keys.shape[0]), reps)
        j = np.arange(parent.shape[0]) - np.repeat(np.cumsum(reps) - reps,
                                                   reps)
        return parent, order[start[parent_keys[parent]] + j]

    title_rows, cast_rows = runs(title["t"], cast["t"])
    pair, comp_rows = runs(cast["t"][cast_rows], comp["t"])
    title_rows, cast_rows = title_rows[pair], cast_rows[pair]
    return {"t": title["t"][title_rows], "kind": title["kind"][title_rows],
            "p": title["p"][title_rows], "person": cast["person"][cast_rows],
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


def device_events(fn, reps: int) -> list:
    """The device-side events (kernels, memsets, copies) of ``reps`` warm
    calls of ``fn`` under ``torch.profiler``, summed by name."""
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
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]


def device_ms(fn, reps: int = 20):
    """Device milliseconds of one warm call of ``fn`` and the device
    operations it runs, the mean of ``reps`` calls."""
    events = device_events(fn, reps)
    busy_us = sum(e.self_device_time_total for e in events)
    return busy_us / 1e3 / reps, sum(e.count for e in events) / reps


def profile_window(fn, label: str, wall_ms_unprofiled: float) -> dict:
    """Device time by kernel over one warm call of ``fn``, and the device's
    idle share of the call's unprofiled wall time."""
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in device_events(fn, 1)),
                     key=lambda k: -k[1])
    busy_ms = sum(t for _, t, _ in kernels) / 1e3
    idle = 1 - busy_ms / wall_ms_unprofiled
    log(f"[profile] {label}: device busy {busy_ms:.3f} ms of "
        f"{wall_ms_unprofiled:.3f} ms warm wall, idle share {idle:.3f}")
    for name, t, count in kernels[:8]:
        log(f"[profile] {label}:   {t / 1e3:8.3f} ms  x{count:<3d} {name[:80]}")
    return {"busy_ms": busy_ms, "idle_share": idle,
            "top": [(name, t / 1e3, count) for name, t, count in kernels[:8]]}


def sass_count(build, name: str, op: str) -> str:
    """How many ``op`` instructions ``cuobjdump -sass`` finds in the built
    library of ``csrc/<name>.cu`` (a note if there is no cuobjdump)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return f"no cuobjdump; {op} not counted"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=300).stdout
    return f"{sass.count(op)} {op} instructions (cuobjdump -sass)"


def ptxas_lines(text: str):
    """(entry function, line) for each register and spill line of an
    ``-Xptxas -v`` report, the entry named by the line that opened it."""
    import re

    entry, out = "?", []
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\w+)", line)
        if m:
            entry = m.group(1)
        elif "registers" in line or "spill" in line:
            out.append((entry[:72], line.replace("ptxas info    :", "").strip()))
    return out


def bound(nbytes: float, nops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
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


def check_draws(label, fd_mod, ps_mod, pack, variants, keys, samples,
                errs) -> None:
    """Every draw of a phase's main path, again through both draw kernels
    and the plain version, under each key: for the configuration's own
    parameters and each other variant, ``fused_draw`` equals
    ``fused_draw_plain`` (rows, positions, count, overflow) and
    ``fused_sample`` equals both in positions, count and overflow; the
    main-path sample under that key is the kernel's draw. Raises the
    kernels' errors in ``errs``; logs the keys whose float32 arrival sum
    dipped (the running max takes the dip out)."""
    import torch

    from repro_torch.kernels import threefry

    dips = []
    for key, smp in zip(keys, samples):
        for name, params, kw in variants:
            full = fd_mod.fused_draw(pack.arena, key, params,
                                     layout=pack.layout, **kw)
            want = fd_mod.fused_draw_plain(pack.arena, key, params,
                                           layout=pack.layout, **kw)
            pos = fd_mod.fused_sample(key, params, **kw)
            assert not bool(want[3]), (label, name)
            errs["fused_draw"] = max(errs["fused_draw"], *(
                max_abs_err(g, w) for g, w in zip(full, want)))
            errs["fused_sample"] = max(errs["fused_sample"], *(
                max_abs_err(g, w) for g, w in zip(pos, want[1:])))
            for g, f in zip(pos, full[1:]):
                assert torch.equal(g, f), (label, name)
            if name != "main":
                continue
            assert torch.equal(smp.positions, full[1].long()), label
            assert int(smp.count) == int(full[2]), label
            assert bool(smp.overflow) == bool(full[3]), label
            u = threefry.uniforms_plain(key, kw["acap"], 0,
                                        pack.arena.device)
            raw = ps_mod.scan_order(-torch.log1p(-u), fd_mod.THREADS,
                                        fd_mod.ITEMS)
            if bool((raw[1:] < raw[:-1]).any()):
                dips.append(int(key[1]))  # the key's seed
    log(f"[check] {label}: {len(keys)} keys x {len(variants)} draws "
        f"({', '.join(v[0] for v in variants)}): fused_draw vs plain "
        f"max_abs_err {errs['fused_draw']}, fused_sample vs plain "
        f"{errs['fused_sample']}, fused_sample equals fused_draw and the "
        f"main-path sample; keys whose raw arrival sum dips: {dips}")
    assert errs["fused_draw"] == 0.0 and errs["fused_sample"] == 0.0


def walk_ops(layout, steps_for) -> int:
    """Operations of one tree walk: 6 per descent step, 12 per edge."""
    ops = 6 * steps_for(layout.root_len)
    for e in layout.edges:
        ops += 6 * steps_for(e.n_child + 1) + 12
    return ops


def draw_bound(plan, layout, steps_for, keys: int = 1):
    """The bound of ``keys`` EXPRACE draws of the draw kernel at the plan's
    shapes: ``fused_draw`` with the walk of ``layout``, ``fused_sample``
    when ``layout`` is None. Bytes: the parameter vectors (and the arena)
    read once, each key's positions, rows and scalars written once;
    operations: each key's arrivals, root prefixes and output lanes."""
    R = plan.w.numel()
    cap, acap = plan.default_capacity(), plan.arrival_capacity()
    s_acap, s_R = steps_for(acap + 1), steps_for(R + 2)
    ops = (acap * (150 + 6 * 2 * s_R + 40) + (R + 1) * 6 * s_acap
           + cap * (6 * (s_R + 2 * s_acap) + 30))
    nbytes = 4 * 7 * (R + 1) + keys * 4 * (cap + 2)
    if layout is not None:
        nbytes += 4 * layout.size + keys * 4 * cap * layout.num_slots
        ops += cap * walk_ops(layout, steps_for)
    return bound(nbytes, keys * ops)


# Widths of the attention checks (src/repro/configs/): heads, KV heads,
# head dim.
LLAMA3_405B = (128, 8, 128)
GEMMA3_1B = (4, 1, 256)
SMOLLM_135M = (9, 3, 64)
GEMMA3_WINDOW = 512
GEO_P = 0.05
# Attention tolerances (rtol, atol), kernel against plain: float32 at the
# reference's own test tolerances; bf16 output at one bf16 ulp (at most
# 2^-7 of the value) plus a float32 margin, well below the outputs' size.
F32_DECODE_TOL = (2e-5, 2e-5)
F32_PREFILL_TOL = (2e-4, 2e-4)
BF16_TOL = (1e-2, 1e-3)
GEO_KEYS = 8


def close(got, want, tol) -> float:
    """max |got - want| in float32; asserts |got - want| <= atol + rtol
    |want| everywhere (``assert_allclose``), with ``tol = (rtol, atol)``."""
    import torch

    rtol, atol = tol
    g, w = got.float(), want.float()
    err = (g - w).abs()
    assert bool(torch.isfinite(g).all())
    worst = float(err.max())
    assert bool((err <= atol + rtol * w.abs()).all()), worst
    return worst


def near_integer_quotient(u, p: float, lanes) -> list:
    """For GEO lanes whose steps differ: is the float64 quotient
    log(u) / log1p(-p) within 2 float32 ulp of an integer?"""
    import numpy as np

    uu = np.maximum(u[lanes].double().cpu().numpy(), np.float32(1e-12))
    pc = np.float64(np.clip(np.float32(p), np.float32(1e-12),
                            np.float32(1.0 - 1e-7)))
    quo = np.log(uu) / np.log1p(-pc)
    ulp = np.spacing(quo.astype(np.float32)).astype(np.float64)
    return list(np.abs(quo - np.round(quo)) <= 2 * ulp)


def library_timed(fn, reps: int, device, label: str):
    """``timed`` for a library yardstick: ``None`` (and a log line) if the
    library call is refused, so a yardstick never stops the check."""
    import torch

    try:
        return timed(fn, reps, device)
    except (RuntimeError, TypeError, ValueError) as exc:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        log(f"[time] {label}: library call refused ({str(exc)[:120]}); "
            "library_ms null")
        return None


def run_ops(args, device, kernels, n_join: int):
    """Phase D: the kernel-ops entry point (``repro_torch.kernels.ops``) at
    the sizes of the configurations the repo has, each kernel held against
    its plain version on the same inputs and timed. Returns the kernel
    rows, the errors and the launches of the phase's main-path run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import geo_gaps as geo_mod
    from repro_torch.kernels import ops, threefry
    from repro_torch.kernels import prefix_sum as ps_mod

    # float32 matrix products of the plain versions in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 3)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def padding_bias(B, S, window=None):
        """0 on each row's valid keys (lengths in [S/2, S]; the last
        ``window`` of them when windowed), -1e30 elsewhere."""
        lens = torch.randint(S // 2, S + 1, (B, 1), generator=gen,
                             device=device)
        pos = torch.arange(S, device=device)[None, :]
        keep = pos < lens
        if window is not None:
            keep &= pos >= lens - window
        return torch.where(keep, 0.0, -1e30).to(f32)

    # -- inputs (set-up) ------------------------------------------------------
    n = args.scan_n
    w_i32 = torch.randint(0, 59, (n,), generator=gen, device=device,
                          dtype=torch.int32)          # sum < 2^31
    w_f32 = (torch.randint(0, 4, (n,), generator=gen, device=device)
             == 0).to(f32)                            # sum < 2^24
    w_rand = torch.rand((n,), generator=gen, device=device)
    w_rand64 = torch.rand((n,), generator=gen, device=device,
                          dtype=torch.float64) * 1e3
    geo_mean = n_join * GEO_P
    geo_sd = math.sqrt(geo_mean * (1 - GEO_P))
    lanes = math.ceil((geo_mean + Z_LIMIT * geo_sd) / 128) * 128
    B, S = args.decode_batch, args.decode_seq
    (Hl, KVl, Dl), (Hg, KVg, Dg), (Hs, KVs, Ds) = LLAMA3_405B, GEMMA3_1B, \
        SMOLLM_135M
    Sf = min(S, 4096)
    dec_cases = {
        f"llama3-405b bf16 B={B} S={S}": (
            randn((B, Hl, Dl), bf16), randn((B, KVl, S, Dl), bf16),
            randn((B, KVl, S, Dl), bf16), padding_bias(B, S), BF16_TOL),
        f"gemma3-1b bf16 B=8 S={S} window {GEMMA3_WINDOW}": (
            randn((8, Hg, Dg), bf16), randn((8, KVg, S, Dg), bf16),
            randn((8, KVg, S, Dg), bf16),
            padding_bias(8, S, GEMMA3_WINDOW), BF16_TOL),
        f"float32 B=2 H=8 KV=2 D=128 S={Sf}": (
            randn((2, 8, 128), f32), randn((2, 2, Sf, 128), f32),
            randn((2, 2, Sf, 128), f32), padding_bias(2, Sf), F32_DECODE_TOL),
    }
    Sp = args.prefill_seq
    ql, kl, vl = (randn((1, Hl, Sp, Dl), bf16), randn((1, KVl, Sp, Dl), bf16),
                  randn((1, KVl, Sp, Dl), bf16))
    qs, ks, vs = (randn((2, Hs, 1000, Ds), f32), randn((2, KVs, 1000, Ds), f32),
                  randn((2, KVs, 1000, Ds), f32))
    qsb, ksb, vsb = (t.to(bf16) for t in (qs, ks, vs))
    # prefill_32k: llama3-405b widths, B 1, causal; checked on three heads
    S32 = args.prefill_long_seq
    q32, k32, v32 = (randn((1, Hl, S32, Dl), bf16),
                     randn((1, KVl, S32, Dl), bf16),
                     randn((1, KVl, S32, Dl), bf16))
    Sg = Sp // 2
    qg, kg, vg = (randn((1, Hg, Sg, Dg), bf16), randn((1, KVg, Sg, Dg), bf16),
                  randn((1, KVg, Sg, Dg), bf16))
    pre_cases = {
        f"llama3-405b bf16 S={Sp} causal": (ql, kl, vl, True, BF16_TOL),
        f"llama3-405b bf16 S={Sp} full": (ql, kl, vl, False, BF16_TOL),
        "smollm-135m float32 B=2 S=1000 causal": (qs, ks, vs, True,
                                                  F32_PREFILL_TOL),
        "smollm-135m bf16 B=2 S=1000 causal": (qsb, ksb, vsb, True,
                                               BF16_TOL),
        "smollm-135m float32 B=2 S=1000 full": (qs, ks, vs, False,
                                                F32_PREFILL_TOL),
        f"gemma3-1b bf16 S={Sg} causal": (qg, kg, vg, True, BF16_TOL),
    }
    keys = [threefry.key(4000 + s) for s in range(GEO_KEYS)]
    if device.type == "cuda":
        torch.cuda.synchronize()

    # -- the main path: the ops wrappers ---------------------------------------
    for fn in kernels.values():
        fn.launches = 0
    ps = {"int32": ops.prefix_sum(w_i32),
          "int32 exclusive": ops.prefix_sum(w_i32, exclusive=True),
          "float32 integer-valued": ops.prefix_sum(w_f32),
          "float32 random": ops.prefix_sum(w_rand),
          "float64 random": ops.prefix_sum(w_rand64)}
    geo = []
    for key in keys:
        u = threefry.uniforms(key, lanes, 0, device)
        geo.append((u, ops.geo_positions_fused(u, GEO_P)))
    dec = {name: ops.decode_attention(q, k, v, bias)
           for name, (q, k, v, bias, _) in dec_cases.items()}
    pre = {name: ops.prefill_attention(q, k, v, causal=causal)
           for name, (q, k, v, causal, _) in pre_cases.items()}
    pre32 = ops.prefill_attention(q32, k32, v32, causal=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    log(f"[D] launches {launches}")
    if device.type == "cuda":
        assert launches["prefix_sum"] == 2
        assert launches["prefix_sum_f32"] == 2
        assert launches["prefix_sum_f64"] == 1
        assert launches["geo_gaps"] == launches["threefry_uniforms"] == GEO_KEYS
        assert launches["flash_decode"] == len(dec_cases)
        assert launches["flash_prefill"] == len(pre_cases) + 1
        assert all(launches[k] == 0 for k in kernels if k not in (
            "prefix_sum", "prefix_sum_f32", "prefix_sum_f64", "geo_gaps",
            "threefry_uniforms", "flash_decode", "flash_prefill"))

    # -- each kernel against its plain version ---------------------------------
    errs = {}
    want_i32 = ps_mod.prefix_sum_plain(w_i32)
    assert torch.equal(want_i32.long(), torch.cumsum(w_i32.long(), 0))
    want_f32 = ps_mod.prefix_sum_plain(w_f32)
    assert torch.equal(want_f32.double(), torch.cumsum(w_f32.double(), 0))
    want_rand = ps_mod.prefix_sum_plain(w_rand)
    want_rand64 = ps_mod.prefix_sum_plain(w_rand64)
    want_ex = torch.cat([want_i32.new_zeros(1), want_i32[:-1]])
    errs["prefix_sum"] = max(
        max_abs_err(ps["int32"], want_i32),
        max_abs_err(ps["int32 exclusive"], want_ex))
    errs["prefix_sum_f32"] = max(
        max_abs_err(ps["float32 integer-valued"], want_f32),
        max_abs_err(ps["float32 random"], want_rand))
    err64 = max_abs_err(ps["float64 random"], want_rand64)
    drift = max_abs_err(ps["float32 random"], torch.cumsum(w_rand.double(), 0))
    log(f"[check] prefix_sum: n {n}, int32 (sum {int(want_i32[-1])}) and "
        f"exclusive, float32 integer-valued (sum {int(want_f32[-1])}) and "
        f"random, float64 random: kernel vs plain max_abs_err "
        f"{errs['prefix_sum']} / {errs['prefix_sum_f32']} / {err64} (random "
        f"float32 against a float64 cumsum: {drift:.4g})")
    assert errs["prefix_sum"] == errs["prefix_sum_f32"] == err64 == 0.0
    # The floats' one launch in its fixed order, bit for bit against
    # scan_order: at one element, around one tile, around one chunk of tile
    # totals (TILE tiles) and over several chunks, and five repeats of one
    # input of each type (the fixed order repeats; the tiles finish in
    # another order each time).
    Tf = ps_mod.TILE
    float_err, repeats_differ = 0.0, 0
    sizes = sorted(m for m in {1, Tf - 1, Tf, Tf + 1, Tf * Tf, Tf * Tf + 1,
                               n} if m <= n)
    for m in sizes:
        for dt in (torch.float32, torch.float64):
            xm = torch.rand((m,), generator=gen, device=device, dtype=dt)
            float_err = max(float_err, max_abs_err(
                ps_mod.prefix_sum_tiles(xm),
                ps_mod.scan_order(xm, ps_mod.THREADS, ps_mod.ITEMS)))
            del xm
    for x0, want in ((w_rand, want_rand), (w_rand64, want_rand64)):
        for _ in range(5):
            repeats_differ += int(not torch.equal(ps_mod.prefix_sum_tiles(x0),
                                                  want))
    log(f"[check] prefix_sum float32 and float64 (one launch) against "
        f"scan_order at n {sizes} ({-(-n // Tf)} tiles, {-(-n // Tf ** 2)} "
        f"chunks of totals at the last): max_abs_err {float_err}; "
        f"five repeats of each type at n {n}: {repeats_differ} differ")
    assert float_err == 0.0 and repeats_differ == 0
    # The int32 and GEO look-back at its edges: one element, each tile
    # size less one, itself and one more, 33 tiles and 7 (the look-back
    # crosses windows), the first n that takes the large tile (one wave of
    # it on this card) and the one before, Cast's rows; full-range values,
    # so the int32 sums wrap.
    T, Ts = ps_mod.LOOK_BACK_TILE, ps_mod.LOOK_BACK_SMALL_TILE
    edges = {1, Ts - 1, Ts, Ts + 1, T - 1, T, T + 1, 33 * T + 7, n}
    switch = None
    if device.type == "cuda":
        lo, hi = 1, 1 << 31
        while lo < hi:
            mid = (lo + hi) // 2
            if ps_mod.look_back_tile(mid) == T:
                hi = mid
            else:
                lo = mid + 1
        switch = lo
        edges |= {switch - 1, switch}
    edges = sorted(edges)
    edge_err = 0.0
    for m in edges:
        xm = torch.randint(-2**31, 2**31, (m,), generator=gen, device=device,
                           dtype=torch.int32)
        um = torch.rand((m,), generator=gen, device=device)
        edge_err = max(edge_err, max_abs_err(ps_mod.prefix_sum_tiles(xm),
                                             ps_mod.prefix_sum_plain(xm)),
                       max_abs_err(geo_mod.geo_gaps_tiles(um, GEO_P),
                                   geo_mod.geo_gaps_plain(um, GEO_P)))
        del xm, um
    log(f"[check] look-back tiles: {Ts} below {switch} elements (one wave "
        f"of {T}-element tiles), {T} from there on")
    # 50 calls back to back at Cast's rows, each against the first, with no
    # host sync between them: a look-back ordering fault (or a status word
    # left over in reused scratch) shows as a rare wrong sum.
    first = ps_mod.prefix_sum_tiles(w_i32)
    wrong = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(50):
        wrong += (ps_mod.prefix_sum_tiles(w_i32) != first).sum()
    log(f"[check] prefix_sum int32 (full-range values) and geo_gaps "
        f"look-back at n {edges}: kernel vs plain max_abs_err {edge_err}; "
        f"50 calls back to back at n {n}: {int(wrong)} elements differ from "
        f"the first call")
    assert edge_err == 0.0 and int(wrong) == 0 and torch.equal(first, want_i32)
    # The two entries in turn, 100 calls back to back on the one scratch
    # of this stream (no reset between them), each against its first
    # call; then both on a second stream, which takes a scratch of its own.
    u0 = geo[0][0]
    first_geo = geo_mod.geo_gaps_tiles(u0, GEO_P)
    wrong_ps = torch.zeros((), dtype=torch.int64, device=device)
    wrong_geo = torch.zeros((), dtype=torch.int64, device=device)
    wrong_f64 = torch.zeros((), dtype=torch.int64, device=device)
    for i in range(150):
        if i % 3 == 1:
            wrong_geo += (geo_mod.geo_gaps_tiles(u0, GEO_P) != first_geo).sum()
        elif i % 3 == 2:
            wrong_f64 += (ps_mod.prefix_sum_tiles(w_rand64)
                          != want_rand64).sum()
        else:
            wrong_ps += (ps_mod.prefix_sum_tiles(w_i32) != first).sum()
    assert int(wrong_ps) == 0 and int(wrong_geo) == 0 and int(wrong_f64) == 0
    assert torch.equal(first_geo, geo_mod.geo_gaps_plain(u0, GEO_P))
    side_note = "no second stream off the card"
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            side_ps = ps_mod.prefix_sum_tiles(w_i32)
            side_geo = geo_mod.geo_gaps_tiles(u0, GEO_P)
            side_f64 = ps_mod.prefix_sum_tiles(w_rand64)
        torch.cuda.current_stream(device).wait_stream(side)
        assert torch.equal(side_ps, first) and torch.equal(side_geo, first_geo)
        assert torch.equal(side_f64, want_rand64)
        side_note = (f"a second stream equal too ({len(ps_mod._SCRATCH)} "
                     "scratches, one a stream)")
        del side_ps, side_geo, side_f64
    log(f"[check] prefix_sum int32, geo_gaps and prefix_sum float64 in turn, "
        f"150 calls back to back on one scratch: {int(wrong_ps)} / "
        f"{int(wrong_geo)} / {int(wrong_f64)} elements differ from the first "
        f"calls (float64: from scan_order); {side_note}")
    del first, first_geo

    errs["geo_gaps"] = errs["threefry_uniforms"] = 0.0
    off_lanes, near, zs = 0, 0, []
    for key, (u, pos) in zip(keys, geo):
        errs["threefry_uniforms"] = max(errs["threefry_uniforms"], max_abs_err(
            u, threefry.uniforms_plain(key, lanes, 0, device)))
        want = geo_mod.geo_gaps_plain(u, GEO_P)
        errs["geo_gaps"] = max(errs["geo_gaps"], max_abs_err(pos, want))
        steps = torch.diff(pos.long(), prepend=pos.new_full((1,), -1).long())
        bad = torch.nonzero(steps != geo_mod.geo_steps_plain(u, GEO_P).long())
        if bad.numel():
            off_lanes += bad.numel()
            near += sum(near_integer_quotient(u, GEO_P, bad.reshape(-1)))
        assert bool((pos[1:] > pos[:-1]).all()) and int(pos[-1]) >= n_join
        zs.append((int((pos < n_join).sum()) - geo_mean) / geo_sd)
    log(f"[check] geo_gaps: p {GEO_P} over n {n_join}, {lanes} lanes, "
        f"{GEO_KEYS} keys: kernel vs plain max_abs_err {errs['geo_gaps']}; "
        f"lanes whose step differs {off_lanes} (of them with a quotient "
        f"within 2 float32 ulp of an integer: {near}); threefry uniforms "
        f"max_abs_err {errs['threefry_uniforms']}; valid counts z vs n p = "
        f"{geo_mean:.1f}: " + ", ".join(f"{z:+.2f}" for z in zs))
    assert off_lanes == 0 and errs["threefry_uniforms"] == 0.0
    assert all(abs(z) < Z_LIMIT for z in zs)

    errs["flash_decode"] = 0.0
    for name, (q, k, v, bias, tol) in dec_cases.items():
        err = close(dec[name], dec_mod.flash_decode_plain(q, k, v, bias), tol)
        errs["flash_decode"] = max(errs["flash_decode"], err)
        log(f"[check] flash_decode {name}: kernel vs plain max_abs_err "
            f"{err:.3g} (rtol, atol {tol})")
    errs["flash_prefill"] = 0.0
    for name, (q, k, v, causal, tol) in pre_cases.items():
        err = close(pre[name], pre_mod.flash_prefill_plain(q, k, v, causal),
                    tol)
        errs["flash_prefill"] = max(errs["flash_prefill"], err)
        log(f"[check] flash_prefill {name}: kernel vs plain max_abs_err "
            f"{err:.3g} (rtol, atol {tol})")
    # prefill_32k: a dense check is (S, S) scores a head, so three query
    # heads, each against the plain version on its slice and its KV head
    G32 = Hl // KVl
    for h in (0, Hl // 2 - 1, Hl - 1):
        j = h // G32
        err = close(pre32[:, h:h + 1], pre_mod.flash_prefill_plain(
            q32[:, h:h + 1], k32[:, j:j + 1], v32[:, j:j + 1], True), BF16_TOL)
        errs["flash_prefill"] = max(errs["flash_prefill"], err)
        log(f"[check] flash_prefill llama3-405b bf16 S={S32} causal, head "
            f"{h} (KV head {j}): kernel vs plain max_abs_err {err:.3g} "
            f"(rtol, atol {BF16_TOL})")
    del dec, pre, pre32

    # -- times ------------------------------------------------------------------
    # (the scans at least 50 calls, as in run())
    reps = args.reps
    reps_short = max(reps, 50)
    rows = []
    call = {"prefix_sum": lambda: ops.prefix_sum(w_i32),
            "geo_gaps": lambda: ops.geo_positions_fused(u0, GEO_P),
            "threefry_uniforms": lambda: threefry.uniforms(keys[0], lanes, 0,
                                                           device)}
    ms = timed(call["prefix_sum"], reps_short, device)
    plain_ms = timed(lambda: ps_mod.prefix_sum_plain(w_i32), 1, device)
    lib_ms = library_timed(lambda: torch.cumsum(w_i32, 0, dtype=torch.int32),
                           reps_short, device, "prefix_sum")
    rows.append(("prefix_sum", "src/repro/kernels/prefix_sum.py:42", "scan.cu",
                 ms, plain_ms, *bound(8 * n, n), lib_ms))
    # the float32 instance (one launch in the fixed order) at the same n
    call["prefix_sum_f32"] = lambda: ops.prefix_sum(w_rand)
    ms = timed(call["prefix_sum_f32"], reps_short, device)
    plain_ms = timed(lambda: ps_mod.prefix_sum_plain(w_rand), 1, device)
    lib_ms = library_timed(lambda: torch.cumsum(w_rand, 0), reps_short,
                           device, "prefix_sum float32")
    rows.append(("prefix_sum_f32", "src/repro/kernels/prefix_sum.py:42",
                 "scan.cu", ms, plain_ms, *bound(8 * n, n), lib_ms))
    ms = timed(call["geo_gaps"], reps_short, device)
    plain_ms = timed(lambda: geo_mod.geo_gaps_plain(u0, GEO_P), 1, device)
    # ~40 operations a lane: two logarithms, a divide, floor, clamp, a scan add
    rows.append(("geo_gaps", "src/repro/kernels/geo_gaps.py:49", "scan.cu",
                 ms, plain_ms, *bound(8 * lanes, 40 * lanes), None))
    ms = timed(call["threefry_uniforms"], reps, device)
    plain_ms = timed(lambda: threefry.uniforms_plain(keys[0], lanes, 0,
                                                     device), 1, device)
    # 250 integer operations a lane: the fold and one 20-round block
    rows.append(("threefry_uniforms", "src/repro/kernels/threefry.py:78",
                 "fused_draw.cu", ms, plain_ms,
                 *bound(4 * lanes, 250 * lanes), None))
    q, k, v, bias, _ = next(iter(dec_cases.values()))
    call["flash_decode"] = lambda: ops.decode_attention(q, k, v, bias)
    ms = timed(call["flash_decode"], reps, device)
    plain_ms = timed(lambda: dec_mod.flash_decode_plain(q, k, v, bias), 1,
                     device)
    mask = (bias == 0)[:, None, None, :]
    lib_ms = library_timed(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), reps, device,
        "flash_decode")
    nbytes = 2 * (k.numel() + v.numel() + 2 * q.numel()) + 4 * bias.numel()
    rows.append(("flash_decode", "src/repro/kernels/flash_decode.py:62",
                 "flash_decode.cu", ms, plain_ms,
                 *bound(nbytes, 4 * q.numel() * k.shape[2], BF16_TC_OPS_PER_S),
                 lib_ms))
    call["flash_prefill"] = lambda: ops.prefill_attention(ql, kl, vl,
                                                          causal=True)
    ms = timed(call["flash_prefill"], reps, device)
    plain_ms = timed(lambda: pre_mod.flash_prefill_plain(ql, kl, vl, True), 1,
                     device)
    lib_ms = library_timed(lambda: F.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True, enable_gqa=True), reps, device,
        "flash_prefill")
    nbytes = 2 * (2 * ql.numel() + kl.numel() + vl.numel())
    rows.append(("flash_prefill", "src/repro/kernels/flash_prefill.py:71",
                 "flash_prefill_tc.cu", ms, plain_ms,
                 *bound(nbytes, 2 * ql.numel() * Sp, BF16_TC_OPS_PER_S),
                 lib_ms))
    # prefill_32k, causal: the kernel, SDPA and the bound (fewer reps)
    reps32 = max(1, reps // 2)
    ms32 = timed(lambda: ops.prefill_attention(q32, k32, v32, causal=True),
                 reps32, device)
    lib32 = library_timed(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, enable_gqa=True), reps32, device,
        "flash_prefill 32k")
    b32 = bound(2 * (2 * q32.numel() + k32.numel() + v32.numel()),
                2 * q32.numel() * S32, BF16_TC_OPS_PER_S)
    # its plain version on one head of 128 (a dense head is (S, S) scores)
    plain32_ms = timed(lambda: pre_mod.flash_prefill_plain(
        q32[:, :1], k32[:, :1], v32[:, :1], True), 1, device)
    call["flash_prefill_32k"] = lambda: ops.prefill_attention(
        q32, k32, v32, causal=True)
    log(f"[time] flash_prefill llama3-405b bf16 S={S32} causal (tensor "
        f"cores): {ms32:.4f} ms (bound {b32[0]:.4f} by {b32[1]}"
        + (f", library {lib32:.4f}" if lib32 is not None else "")
        + f"; plain on one head of {Hl} {plain32_ms:.3f})")
    # the float32 instances, on the CUDA cores
    qf, kf, vf, bf, _ = list(dec_cases.values())[2]
    f32_dec_ms = timed(lambda: ops.decode_attention(qf, kf, vf, bf), reps,
                       device)
    f32_pre_ms = timed(lambda: ops.prefill_attention(qs, ks, vs, causal=True),
                       reps, device)
    f32_dec_plain = timed(lambda: dec_mod.flash_decode_plain(qf, kf, vf, bf),
                          1, device)
    f32_pre_plain = timed(lambda: pre_mod.flash_prefill_plain(qs, ks, vs,
                                                              True), 1, device)
    call["flash_decode_f32"] = lambda: ops.decode_attention(qf, kf, vf, bf)
    call["flash_prefill_f32"] = lambda: ops.prefill_attention(qs, ks, vs,
                                                              causal=True)
    maskf = (bf == 0)[:, None, None, :]
    f32_dec_lib = library_timed(lambda: F.scaled_dot_product_attention(
        qf[:, :, None], kf, vf, attn_mask=maskf, enable_gqa=True), reps,
        device, "flash_decode float32")
    f32_pre_lib = library_timed(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), reps, device,
        "flash_prefill float32")
    # their bounds: float32 bytes, operations at the float32 rate outside
    # the tensor cores (the kernels' own)
    f32_dec_bound = bound(4 * (kf.numel() + vf.numel() + 2 * qf.numel()
                               + bf.numel()), 4 * qf.numel() * kf.shape[2])
    f32_pre_bound = bound(4 * (2 * qs.numel() + ks.numel() + vs.numel()),
                          2 * qs.numel() * qs.shape[2])
    log(f"[time] flash_decode float32 (CUDA cores) B=2 H=8 KV=2 D=128 "
        f"S={Sf}: {f32_dec_ms:.4f} ms (plain {f32_dec_plain:.3f}, library "
        f"{f32_dec_lib}, bound {f32_dec_bound[0]:.4f} by "
        f"{f32_dec_bound[1]}); flash_prefill float32 (CUDA cores) "
        f"smollm-135m B=2 S=1000 causal: {f32_pre_ms:.4f} ms (plain "
        f"{f32_pre_plain:.3f}, library {f32_pre_lib}, bound "
        f"{f32_pre_bound[0]:.4f} by {f32_pre_bound[1]})")
    sizes = {"scan_n": n, "geo_join": n_join, "geo_lanes": lanes,
             "decode": list(dec_cases), "prefill": list(pre_cases),
             "prefill_32k": {"S": S32, "ms": ms32, "library_ms": lib32,
                             "bound_ms": b32[0], "bound_by": b32[1],
                             "plain_one_head_ms": plain32_ms},
             "float32_ms": {"flash_decode": f32_dec_ms,
                            "flash_prefill": f32_pre_ms,
                            "flash_decode_plain": f32_dec_plain,
                            "flash_prefill_plain": f32_pre_plain,
                            "flash_decode_library": f32_dec_lib,
                            "flash_prefill_library": f32_pre_lib,
                            "flash_decode_bound": f32_dec_bound,
                            "flash_prefill_bound": f32_pre_bound}}
    # device time of each row's call, after every timing of the phase
    sizes["device_ms"] = {name: device_ms(fn) for name, fn in call.items()} \
        if device.type == "cuda" else {}
    if device.type == "cuda" and args.profile:
        # device time against the wrapper's: the host side of a call
        # (ctypes, allocations) shows where the kernels are short
        for label, fn in (
                ("prefix_sum", lambda: ops.prefix_sum(w_i32)),
                ("geo_positions_fused", lambda: ops.geo_positions_fused(
                    u0, GEO_P)),
                ("decode_attention", lambda: ops.decode_attention(
                    q, k, v, bias)),
                ("prefill_attention", lambda: ops.prefill_attention(
                    ql, kl, vl, causal=True))):
            sizes[f"profile_{label}"] = profile_window(
                fn, label, wall_ms(fn, device))
    return rows, errs, launches, sizes


def lane(smp, b: int):
    """Lane b of a batched sample, as a single one."""
    from repro_torch.core import JoinSample

    return JoinSample({v: c[b] for v, c in smp.columns.items()},
                      smp.positions[b], smp.count[b], smp.overflow[b])


def assert_same_sample(a, b, label) -> None:
    """Positions, count, overflow and every column bit for bit."""
    import torch

    assert torch.equal(a.positions, b.positions), label
    assert int(a.count) == int(b.count), label
    assert bool(a.overflow) == bool(b.overflow), label
    assert set(a.columns) == set(b.columns), label
    for v, col in b.columns.items():
        assert torch.equal(a.columns[v], col), (label, v)


def rows_multiset(cols, names):
    """The rows of a join as one sorted (n, columns) int64 array (float
    columns by their bits): a multiset to compare joins in any order."""
    import numpy as np

    arr = np.stack([np.asarray(cols[v]).astype(np.float64).view(np.int64)
                    if np.asarray(cols[v]).dtype.kind == "f"
                    else np.asarray(cols[v]).astype(np.int64)
                    for v in names], axis=1)
    return arr[np.lexsort(arr.T[::-1])]


def run_batched(args, device, q, configs, fulls, kernels, errs, steps):
    """Phase E: batched draws, the uniform samplers and the facades.

    E.B, E.C, E.A drive ``sample_batch`` at B (one ``fused_draw_batch``
    launch a batch), C (one ``fused_sample_batch`` and one paged GET
    launch) and A (the per-node route: per-key positions, one
    ``tree_probe`` launch), each with the counts zeroed just before and
    read just after; every lane is then held bit for bit against
    ``sample(keys[b])``. The batched kernels are held against their plain
    versions; ``uniform_sample`` runs at A (HYBRID -> GEO and -> BERN) and
    BINOM at B, ``materialize_and_scan``, ``binary_join`` and
    ``PoissonSampler`` at B; five per-node draws of one key at A and two
    builds of the fused draw's tables must repeat bit for bit. Then the
    times. Returns the launches of each main path, the kernels' rows, the
    calls for their device times, the end-to-end times and the warm calls
    to profile."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.core import (Atom, Database, JoinQuery, PoissonSampler,
                                  estimate, sampling, yannakakis)
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import fused_draw as fd_mod
    from repro_torch.kernels import prefix_sum as ps_mod
    from repro_torch.kernels import threefry

    on_card = device.type == "cuda"
    (tabA, engA, planA), (tabB, engB, planB), (tabC, engC, planC) = (
        configs[k] for k in "ABC")
    fullA, fullB, fullC = fulls
    launches = {}

    def main_path(label, fn):
        for f in kernels.values():
            f.launches = 0
        out = fn()
        launches[label] = {k: f.launches for k, f in kernels.items()}
        log(f"[{label}] launches " + str({k: v for k, v in
                                          launches[label].items() if v}))
        return out

    def count_z(plan, counts):
        mean = plan.expected_k()
        sd = float(estimate.sample_std(plan.w, plan.p))
        return (float(np.mean(counts)) - mean) / (sd / math.sqrt(len(counts)))

    def check_lanes(label, eng, full, smp, keys):
        assert smp.batch == len(keys), (label, smp.batch)
        counts = []
        for b in range(len(keys)):
            one = lane(smp, b)
            assert_same_sample(one, eng.sample(q, keys[b]), (label, b))
            counts.append(check_sample(one, full, label))
        return counts

    # -- E.B: the fused batch -------------------------------------------------
    keysB = threefry.keys(2000, args.draws)
    keys6 = threefry.keys(2006, 6)
    smpB, smpB6 = main_path("E.B", lambda: (engB.sample_batch(q, keysB),
                                            engB.sample_batch(q, keys6)))
    if on_card:
        lb = launches["E.B"]
        assert lb["fused_draw_batch"] == 2 and lb["fused_draw"] == 0, lb
        assert lb["tree_probe"] == 0 and lb["fused_sample_batch"] == 0, lb
    countsB = check_lanes("E.B", engB, fullB, smpB, keysB)
    check_lanes("E.B, 6 keys padded to 8", engB, fullB, smpB6, keys6)
    zB = count_z(planB, countsB)
    log(f"[E.B] sample_batch of {len(keysB)} keys and of 6 (padded to 8): "
        f"every lane equals sample(keys[b]) bit for bit; mean count "
        f"{np.mean(countsB):.1f} vs E[k] {planB.expected_k():.1f}, z {zB:+.2f}")
    assert abs(zB) < Z_LIMIT
    del smpB, smpB6

    # -- E.C: the paged batch -------------------------------------------------
    keysC = threefry.keys(3000, args.draws)
    keys6C = threefry.keys(3006, 6)
    smpC, smpC6 = main_path("E.C", lambda: (engC.sample_batch(q, keysC),
                                            engC.sample_batch(q, keys6C)))
    if on_card:
        lc = launches["E.C"]
        assert lc["fused_sample_batch"] == 2 and lc["fused_sample"] == 0, lc
        assert lc["tree_probe_paged"] == 2 and lc["fused_draw_batch"] == 0, lc
        assert lc["tree_probe_paged_pages"] == 0 and lc["tree_probe"] == 0, lc
    countsC = check_lanes("E.C", engC, fullC, smpC, keysC)
    check_lanes("E.C, 6 keys padded to 8", engC, fullC, smpC6, keys6C)
    zC = count_z(planC, countsC)
    log(f"[E.C] sample_batch of {len(keysC)} keys and of 6: every lane "
        f"equals sample(keys[b]); mean count {np.mean(countsC):.1f} vs E[k] "
        f"{planC.expected_k():.1f}, z {zC:+.2f}")
    assert abs(zC) < Z_LIMIT
    del smpC, smpC6

    # -- E.A: the per-node batch ------------------------------------------------
    keysA = threefry.keys(1000, 4)
    smpA = main_path("E.A", lambda: engA.sample_batch(q, keysA))
    if on_card:
        la = launches["E.A"]
        assert la["tree_probe"] == 1 and la["bsearch_probe"] == 2 * len(keysA)
        assert la["prefix_sum_f64"] == len(keysA) and la["prefix_sum"] == 0
        assert la["fused_draw_batch"] == 0
    countsA = check_lanes("E.A", engA, fullA, smpA, keysA)
    zA = count_z(planA, countsA)
    log(f"[E.A] sample_batch of {len(keysA)} keys on the per-node route: "
        f"every lane equals sample(keys[b]); counts {countsA}, z {zA:+.2f}")
    assert abs(zA) < Z_LIMIT
    del smpA

    # -- the repeats: one key, one sample; one database, one set of tables ----
    key = threefry.key(1000)
    first = engA.sample(q, key)
    for r in range(4):
        assert_same_sample(engA.sample(q, key), first, ("repeat", r))
    for label, eng, plan in (("A", engA, planA), ("B", engB, planB)):
        one, two = (sampling.fused_draw_params(plan.w, plan.p, plan.prefE,
                                               eng.kernel_policy)
                    for _ in range(2))
        assert all(torch.equal(one[k], two[k]) for k in one), label
        if plan.draw_params is not None:
            assert all(torch.equal(one[k], plan.draw_params[k]) for k in one)
    log("[E] five per-node draws of one key at A equal bit for bit "
        "(positions, count, overflow, every column); fused_draw_params built "
        "twice at A and at B equal, and equal the plan's")

    # -- the batched kernels against their plain versions ------------------------
    # Every search of the kernel goes by tiles, staged in shared memory or
    # falling back lane by lane; the sparse plan (B's tables at p = 0.01)
    # spreads an output tile over many roots, so its tiles fall back. Each
    # check's staged and fallback tile searches are the kernel's own
    # (``tile_stats``, both instances) and must equal the plain model's
    # (``fused_draw_batch_tiled``). Title |><| Cast (2 slots) and a join of
    # five relations (Cast and Comp twice: the walk's 16-slot instance) take
    # other layouts and shared memory sizes.
    errs["fused_draw_batch"] = errs["fused_sample_batch"] = 0.0
    keys64 = threefry.keys(4000, 64)

    def plan_of(tables, query):
        return QueryEngine(Database.from_columns(tables, device=device),
                           device=device,
                           kernel_policy=engB.kernel_policy).compile(query)

    planS = plan_of(dict(tabB, Title=dict(tabB["Title"], p=np.full_like(
        tabB["Title"]["p"], 0.01))), q)
    assert planS.route == "fused"
    planTC = engB.compile(JoinQuery(q.atoms[:2], prob_var="p"))
    tab5 = make_tables(args.seed + 5, max(args.serving_title_rows // 8, 100))
    tab5["Cast2"] = {"t": tab5["Cast"]["t"], "person2": tab5["Cast"]["person"]}
    tab5["Comp2"] = {"t": tab5["Comp"]["t"], "comp2": tab5["Comp"]["comp"]}
    plan5 = plan_of(tab5, JoinQuery(q.atoms + (
        Atom.of("Cast2", "t", "person2"), Atom.of("Comp2", "t", "comp2")),
        prob_var="p"))
    assert plan5.shred.packed.layout.num_slots == 5
    tiles = {"staged": 0, "fallback": 0}
    for label, plan, keys, method in (
            ("B", planB, keysB, "exprace"),
            ("B, flat PTBERN", planB, keysB, "ptbern_flat"),
            ("B, one key", planB, keysB[:1], "exprace"),
            ("C", planC, keysC, "exprace"),
            ("C, a bucket of 64", planC, keys64, "exprace"),
            ("B at p = 0.01", planS, keysB, "exprace"),
            ("B, Title |><| Cast", planTC, keysB, "exprace"),
            ("five relations", plan5, keysB[:4], "exprace")):
        pk = plan.shred.packed
        kw = dict(method=method, cap=plan.default_capacity(),
                  acap=plan.arrival_capacity() if method == "exprace" else 0,
                  n=plan.join_size if method == "ptbern_flat" else 0)
        got = fd_mod.fused_draw_batch(pk.arena, keys, plan.draw_params,
                                      layout=pk.layout, **kw)
        want = fd_mod.fused_draw_batch_plain(pk.arena, keys, plan.draw_params,
                                             layout=pk.layout, **kw)
        pos = fd_mod.fused_sample_batch(keys, plan.draw_params, **kw)
        e_draw = max(max_abs_err(g, w) for g, w in zip(got, want))
        e_sample = max(max_abs_err(g, w) for g, w in zip(pos, want[1:]))
        errs["fused_draw_batch"] = max(errs["fused_draw_batch"], e_draw)
        errs["fused_sample_batch"] = max(errs["fused_sample_batch"], e_sample)
        assert not bool(want[3].any()), label
        model = {}
        fd_mod.fused_draw_batch_tiled(None, keys, plan.draw_params,
                                      stats=model, **kw)
        counts = {"model": {k: model.get(k, 0) for k in tiles}}
        if on_card:
            counts["fused_draw_batch"] = fd_mod.tile_stats(
                pk.arena, None, plan.draw_params, layout=pk.layout,
                keys=keys, **kw)
            counts["fused_sample_batch"] = fd_mod.tile_stats(
                None, None, plan.draw_params, keys=keys, **kw)
            assert all(c == counts["model"] for c in counts.values()), counts
        for k in tiles:
            tiles[k] += counts["model"][k]
        log(f"[check] fused_draw_batch / fused_sample_batch at {label} "
            f"({len(keys)} keys, {method}): vs plain max_abs_err {e_draw} / "
            f"{e_sample}; tile searches staged / fallback " + "; ".join(
                f"{k} {c['staged']} / {c['fallback']}"
                for k, c in counts.items()))
        del got, want, pos
    log(f"[check] the batched draw's tile searches over the checks: "
        f"{tiles['staged']} staged, {tiles['fallback']} fell back")
    assert tiles["staged"] > 0 and tiles["fallback"] > 0, tiles
    del planS, planTC, plan5
    if on_card:
        for label, walk, plan, nkeys in (("B", True, planB, args.draws),
                                         ("C", False, planC, args.draws),
                                         ("C", False, planC, 64)):
            per_sm, sms, blocks, smem = fd_mod.grid(
                walk, plan.arrival_capacity(), plan.default_capacity(),
                plan.w.numel(), nkeys, layout=plan.shred.packed.layout)
            lanes, R = plan.arrival_capacity(), plan.w.numel()
            slab = (fd_mod.scratch_bytes(lanes, R, 2)
                    - fd_mod.scratch_bytes(lanes, R, 1))
            log(f"[build] {'fused_draw' if walk else 'fused_sample'} batch of "
                f"{nkeys} at {label}: occupancy {per_sm} x {sms}; {blocks} "
                f"blocks launched; {smem} bytes of dynamic shared memory; "
                f"scratch {slab} bytes a key, "
                f"{fd_mod.scratch_bytes(lanes, R, nkeys)} for the batch")
    assert errs["fused_draw_batch"] == 0.0
    assert errs["fused_sample_batch"] == 0.0

    # -- uniform samplers ----------------------------------------------------
    def uniform(label, eng, full, p, method, seeds):
        n = eng.join_size(q)
        for s in seeds:
            smp = eng.uniform_sample(q, threefry.key(s), p, method=method)
            c = check_sample(smp, full, label)
            z = (c - n * p) / math.sqrt(n * p * (1 - p))
            log(f"[{label}] uniform_sample p={p} {method}: count {c} of cap "
                f"{smp.capacity} vs n p {n * p:.1f}, z {z:+.2f}; rows are the "
                "join's at their positions")
            assert abs(z) < Z_LIMIT

    main_path("E.U", lambda: (
        uniform("E.U A", engA, fullA, 0.05, "hybrid", (5000, 5001)),
        uniform("E.U A", engA, fullA, 0.7, "hybrid", (5002,)),
        uniform("E.U B", engB, fullB, 0.3, "binom", (5003, 5004))))

    # -- facades ---------------------------------------------------------------
    cols, keep = engB.materialize_and_scan(threefry.key(6000), q)
    pB = cols["p"].double()
    z = (float(keep.sum()) - float(pB.sum())) / math.sqrt(
        float((pB * (1 - pB)).sum()))
    assert abs(z) < Z_LIMIT
    for v, col in fullB.items():
        assert torch.equal(cols[v], col), v
    log(f"[E facades] materialize_and_scan at B: columns equal the full "
        f"join; kept {int(keep.sum())} of {keep.numel()} vs sum p "
        f"{float(pB.sum()):.1f}, z {z:+.2f}")
    del cols, keep, pB
    bj = yannakakis.binary_join(engB.db, q)
    want = expand_numpy(tabB)
    names = sorted(want)
    assert sorted(bj) == names
    assert np.array_equal(rows_multiset({v: c.cpu().numpy() for v, c in
                                         bj.items()}, names),
                          rows_multiset(want, names))
    log(f"[E facades] binary_join at B: {bj[names[0]].shape[0]} rows, as a "
        "multiset the numpy expansion's")
    del bj
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        sampler = PoissonSampler(engB.db, q, kernel_policy=engB.kernel_policy)
    assert_same_sample(sampler.sample(threefry.key(77)),
                       engB.sample(q, threefry.key(77)), "PoissonSampler")
    log("[E facades] PoissonSampler.sample equals engine.sample at B")
    del sampler

    # -- times ----------------------------------------------------------------
    reps = args.reps
    e2e = {}
    for label, eng, keys, nreps in (("B", engB, keysB, reps),
                                    ("C", engC, keysC, reps),
                                    ("A", engA, keysA, 2)):
        e2e[f"sample_batch_{label}_{len(keys)}_ms"] = timed(
            lambda: eng.sample_batch(q, keys), nreps, device)
        e2e[f"sample_loop_{label}_{len(keys)}_ms"] = timed(
            lambda: [eng.sample(q, k) for k in keys], nreps, device)
        log(f"[time] {label}: sample_batch of {len(keys)} keys "
            f"{e2e[f'sample_batch_{label}_{len(keys)}_ms']:.3f} ms; "
            f"{len(keys)} single warm draws in a loop "
            f"{e2e[f'sample_loop_{label}_{len(keys)}_ms']:.3f} ms")
    for p in (0.05, 0.7):
        e2e[f"uniform_sample_A_p{p}_ms"] = timed(
            lambda: engA.uniform_sample(q, threefry.key(5000), p), reps,
            device)
        log(f"[time] A: uniform_sample p={p} "
            f"{e2e[f'uniform_sample_A_p{p}_ms']:.3f} ms")
    rows, call = [], {}
    capB = planB.default_capacity()
    kwB = dict(layout=planB.shred.packed.layout, method="exprace", cap=capB,
               acap=planB.arrival_capacity())
    call["fused_draw_batch"] = lambda: fd_mod.fused_draw_batch(
        planB.shred.packed.arena, keysB, planB.draw_params, **kwB)
    ms = timed(call["fused_draw_batch"], reps, device)
    plain_ms = timed(lambda: fd_mod.fused_draw_batch_plain(
        planB.shred.packed.arena, keysB, planB.draw_params, **kwB), 1, device)
    b_ms, b_by = draw_bound(planB, planB.shred.packed.layout, steps,
                            len(keysB))
    rows.append(("fused_draw_batch", "src/repro/kernels/fused_draw.py:212",
                 ms, plain_ms, b_ms, b_by, None))
    kwC = dict(method="exprace", cap=planC.default_capacity(),
               acap=planC.arrival_capacity())
    call["fused_sample_batch"] = lambda: fd_mod.fused_sample_batch(
        keysC, planC.draw_params, **kwC)
    ms = timed(call["fused_sample_batch"], reps, device)
    plain_ms = timed(lambda: fd_mod.fused_sample_batch_plain(
        keysC, planC.draw_params, **kwC), 1, device)
    b_ms, b_by = draw_bound(planC, None, steps, len(keysC))
    rows.append(("fused_sample_batch", "src/repro/kernels/fused_draw.py:261",
                 ms, plain_ms, b_ms, b_by, None))
    # The float64 scan at A's mass prefix (R lanes: its R + 1 entries less
    # the leading zero), against torch.cumsum.
    pA = torch.clamp(planA.p.double(), 0.0, 1.0)
    lamA = -torch.log1p(-torch.clamp(torch.where(pA > 0.5, 1.0 - pA, pA),
                                     max=0.5))
    xA = planA.w.double() * lamA
    errs["prefix_sum_f64"] = max_abs_err(ps_mod.prefix_sum_tiles(xA),
                                         ps_mod.prefix_sum_plain(xA))
    log(f"[check] prefix_sum float64 at A's {xA.numel()} masses: kernel vs "
        f"plain max_abs_err {errs['prefix_sum_f64']}")
    assert errs["prefix_sum_f64"] == 0.0
    # What the fixed order repairs: the library scan repeated on the same
    # masses (off the port's path since this change), and its float32 cast,
    # which the fused draw's tables take.
    lib = [torch.cumsum(xA, 0) for _ in range(20)]
    differ = sum(not torch.equal(x, lib[0]) for x in lib[1:])
    differ32 = sum(not torch.equal(x.float(), lib[0].float()) for x in lib[1:])
    first = ps_mod.prefix_sum_tiles(xA)
    fixed = sum(not torch.equal(ps_mod.prefix_sum_tiles(xA), first)
                for _ in lib[1:])
    e2e["cumsum_f64_repeats_differing"] = {
        "torch.cumsum": differ, "torch.cumsum as float32": differ32,
        "prefix_sum_tiles": fixed, "of": len(lib) - 1}
    log(f"[E] repeated at A's masses, differing from the first: "
        f"torch.cumsum in float64 {differ} of {len(lib) - 1} ({differ32} "
        f"after the cast to float32); the fixed-order scan {fixed}")
    assert fixed == 0
    del lib
    call["prefix_sum_f64"] = lambda: ps_mod.prefix_sum_tiles(xA)
    ms = timed(call["prefix_sum_f64"], max(reps, 50), device)
    plain_ms = timed(lambda: ps_mod.prefix_sum_plain(xA), 1, device)
    lib_ms = timed(lambda: torch.cumsum(xA, 0), max(reps, 50), device)
    b_ms, b_by = bound(16 * xA.numel(), xA.numel())
    rows.append(("prefix_sum_f64", "src/repro/kernels/prefix_sum.py:42",
                 ms, plain_ms, b_ms, b_by, lib_ms))
    windows = {
        "sample_batch_B": (lambda: engB.sample_batch(q, keysB),
                           e2e[f"sample_batch_B_{len(keysB)}_ms"]),
        "sample_batch_C": (lambda: engC.sample_batch(q, keysC),
                           e2e[f"sample_batch_C_{len(keysC)}_ms"]),
        "sample_batch_A": (lambda: engA.sample_batch(q, keysA),
                           e2e[f"sample_batch_A_{len(keysA)}_ms"]),
        "uniform_sample_A": (lambda: engA.uniform_sample(
            q, threefry.key(5000), 0.05), e2e["uniform_sample_A_p0.05_ms"]),
    }
    phases = ((planB.shred.packed.arena, keysB, planB.draw_params, kwB),
              (None, keysC, planC.draw_params, kwC))
    return launches, rows, call, e2e, windows, phases


def churn_spec(tables, relation: str, frac: float, rng):
    """``benchmarks/bench_updates.py`` ``_churn_delta`` as ``DeltaBatch.of``
    keywords: ``frac`` of the relation's rows deleted and as many inserted,
    the inserts resampled from the relation itself (keys stay in
    distribution, the row count is kept)."""
    n = next(iter(tables[relation].values())).shape[0]
    k = max(1, int(frac * n))
    cols = {c: v[rng.integers(0, n, k)] for c, v in tables[relation].items()}
    return {relation: {"insert": cols,
                       "delete": rng.choice(n, k, replace=False)}}


def reprice_spec(tables, frac: float, rng):
    """A delta of Title and Comp together: ``frac`` of the titles get a new
    ``p`` (each row deleted and inserted again with a fresh p ~ Beta(2,
    10), so it moves to the end), and ``frac`` of Comp churns."""
    title = tables["Title"]
    n = title["t"].shape[0]
    k = max(1, int(frac * n))
    rows = rng.choice(n, k, replace=False)
    spec = {"Title": {"delete": rows, "insert": {
        "t": title["t"][rows], "kind": title["kind"][rows],
        "p": rng.beta(2, 10, k)}}}
    spec.update(churn_spec(tables, "Comp", frac, rng))
    return spec


def applied_tables(tables, spec):
    """The host tables after the delta ``spec``: survivors, then inserts
    cast to the column's dtype."""
    import numpy as np

    out = dict(tables)
    for name, s in spec.items():
        cols = tables[name]
        keep = np.ones(next(iter(cols.values())).shape[0], bool)
        keep[np.asarray(s.get("delete", []), dtype=np.int64)] = False
        out[name] = {c: np.concatenate(
            [v[keep], np.asarray(s.get("insert", {}).get(c, v[:0]))
             .astype(v.dtype)]) for c, v in cols.items()}
    return out


def shred_arrays(shred):
    """(path, value) of every array, name and layout of an index."""
    out = [("rep", shred.rep), ("root_prefE", shred.root_prefE)]

    def node(nd, path):
        out.append((path, (nd.name, nd.variables, nd.owned)))
        out.extend((f"{path}.data.{c}", v) for c, v in nd.data.columns.items())
        out.extend((f"{path}.{f}", getattr(nd, f))
                   for f in ("weight", "nxt", "perm", "cumw_excl"))
        for f in ("child_hd", "child_start", "child_len", "child_w"):
            out.extend((f"{path}.{f}[{i}]", a)
                       for i, a in enumerate(getattr(nd, f)))
        for c in nd.children:
            node(c, f"{path}.{c.name}")

    node(shred.root, shred.root.name)
    for attr, form in (("arena", shred.packed), ("buffer", shred.paged)):
        out.append((attr, None if form is None else getattr(form, attr)))
        out.append((attr + ".layout", None if form is None else form.layout))
    return out


def assert_same_shred(got, want, label) -> int:
    """Two indexes equal array for array (dtypes and shapes included) and
    layout for layout; returns the number of entries compared."""
    import torch

    a, b = shred_arrays(got), shred_arrays(want)
    assert [p for p, _ in a] == [p for p, _ in b], label
    for (path, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            assert isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)
            assert x.dtype == y.dtype and x.shape == y.shape, (label, path)
            assert torch.equal(x, y), (label, path)
        else:
            assert x == y, (label, path, x, y)
    return len(a)


def run_updates(args, device, q, configs, kernels, errs, dev_ms):
    """Phase F: updates on the card, at A, B and C on their own tables.

    At each configuration two deltas in turn: a churn of Cast
    (``bench_updates.py``'s 0.5% each way), then Title's p and rows with a
    churn of Comp. For each: ``reshred_incremental`` of the warm index
    equals ``build_shred`` of the new snapshot array for array (arena or
    pages included); the main path (counts zeroed just before, read just
    after) is ``apply_delta`` on the warm engine, a full join and draws;
    the join equals the numpy expansion of the new tables, each draw equals
    a fresh engine's under the same key and caps, and the cache shows
    upgrades and no builds. At B a route flip (the fewest Cast inserts
    that take the arena over ``draw_limit``, then their delete). At A the
    CSR index: its full join (the ``csr_walk`` kernel, an edge a launch)
    and one draw's rows against the USR GET's, ``csr_get_rows_cached`` over
    every position (``csr_walk_cached``) against ``csr_get_rows``, and both
    walk kernels on each edge's operands against their plain versions.
    Then the times. Returns the launches of each main path, the times and
    the walk kernels' rows (their errors into ``errs``, their device times
    into ``dev_ms``)."""
    import numpy as np
    import torch

    from repro_torch.core import (DeltaBatch, build_shred, probe,
                                  reshred_incremental)
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import csr_walk as cw_mod
    from repro_torch.kernels import threefry

    on_card = device.type == "cuda"
    rng = np.random.default_rng(args.seed + 19)
    launches, e2e, krows, call = {}, {}, [], {}

    def main_path(label, fn):
        for f in kernels.values():
            f.launches = 0
        out = fn()
        launches[label] = {k: f.launches for k, f in kernels.items()}
        log(f"[{label}] launches " + str({k: v for k, v in
                                          launches[label].items() if v}))
        return out

    def step(label, tables, eng, spec, keys):
        """One delta at one configuration; returns the new host tables
        and the draws of its main path."""
        plan = eng.compile(q)
        pol = eng.kernel_policy
        delta = DeltaBatch.of(**spec)
        db0, base = eng.db, plan.shred
        t0 = time.perf_counter()
        inc = reshred_incremental(base, db0, q, delta, pol)
        fresh = build_shred(db0.apply(delta), q, rep=base.rep, policy=pol)
        n = assert_same_shred(inc, fresh, label)
        log(f"[{label}] delta of {delta.size()} rows "
            f"({', '.join(delta.touched())}): reshred_incremental equals "
            f"build_shred of the new snapshot in all {n} arrays and layouts "
            f"(arena {'packed' if inc.packed is not None else 'paged'}, "
            f"{(inc.packed or inc.paged).layout.size} int32; "
            f"{time.perf_counter() - t0:.1f} s with the checks)")
        del inc, fresh
        st0 = eng.stats.snapshot()

        def drive():
            eng.apply_delta(delta)
            return eng.full_join(q), [eng.sample(q, k) for k in keys]

        full, smps = main_path(label, drive)
        st1 = eng.stats
        assert st1.shred_builds == st0.shred_builds, (label, st1)
        assert st1.plan_misses == st0.plan_misses, (label, st1)
        assert st1.shred_upgrades > st0.shred_upgrades, (label, st1)
        assert st1.plan_upgrades > st0.plan_upgrades, (label, st1)
        assert eng.compile(q) is plan and eng.db.version == db0.version + 1
        tables = applied_tables(tables, spec)
        check_join(full, tables, label)
        for smp in smps:
            check_sample(smp, full, label)
        del full
        fresh_eng = QueryEngine(eng.db, device=device, kernel_policy=pol)
        fplan = fresh_eng.compile(q)
        # the engine's own upgrade (given the new snapshot) against a build
        assert_same_shred(plan.shred, fplan.shred, (label, "engine"))
        assert plan.route == fplan.route, (label, plan.route, fplan.route)
        assert plan.rep_default == fplan.rep_default, label
        for key, smp in zip(keys, smps):
            assert_same_sample(smp, fresh_eng.sample(
                q, key, cap=plan.default_capacity(),
                acap=plan.arrival_capacity()), (label, "fresh engine"))
        log(f"[{label}] apply_delta: version {eng.db.version}, route "
            f"{plan.route}, GET {plan.rep_default}; the full join equals the "
            f"numpy expansion of the new tables; {len(keys)} draws equal a "
            f"fresh engine's bit for bit; cache {st1}")
        return tables, smps

    current = {}
    for label in "ABC":
        tables, eng, plan = configs[label]
        keys = [threefry.key(19_000 + s)
                for s in range(args.keys if label == "A" else 4)]
        spec1 = churn_spec(tables, "Cast", 0.005, rng)
        tables, smps = step(f"F.{label}", tables, eng, spec1, keys)
        assert plan.route == {"A": "pernode", "B": "fused",
                              "C": "paged"}[label], (label, plan.route)
        if on_card:
            lf = launches[f"F.{label}"]
            if label == "A":
                assert lf["tree_probe"] == 1 + len(keys), lf
                assert lf["bsearch_probe"] > 0, lf
                assert lf["prefix_sum_f64"] > 0, lf
            elif label == "B":
                assert lf["fused_draw"] == len(keys), lf
                assert lf["tree_probe"] == 1, lf
            else:
                assert lf["fused_sample"] == len(keys), lf
                assert lf["tree_probe_paged"] == len(keys), lf
        if label == "A":
            smpA = smps[0]
        del smps
        tables, _ = step(f"F.{label}2", tables, eng,
                         reprice_spec(tables, 0.005, rng), keys)
        current[label] = tables

    # -- the route flip at B -----------------------------------------------
    _, engB, planB = configs["B"]
    lay = planB.shred.packed.layout
    limit = engB.kernel_policy.draw_limit
    # Words one Cast row adds: cumw_excl and perm where Cast is a child,
    # child_start and child_w on each edge where it is the parent.
    per_row = 2 * sum((lay.names[e.slot] == "Cast") + (lay.names[e.parent]
                                                        == "Cast")
                      for e in lay.edges)
    count = (limit - lay.size) // per_row + 1
    assert lay.size + per_row * (count - 1) <= limit < lay.size + per_row * count
    n_cast = current["B"]["Cast"]["t"].shape[0]
    rows = rng.integers(0, n_cast, count)
    grow = {"Cast": {"insert": {c: v[rows]
                                for c, v in current["B"]["Cast"].items()}}}
    keysF = [threefry.key(19_100 + s) for s in range(2)]
    tabB, _ = step("F.B flip", current["B"], engB, grow, keysF)
    grown = planB.shred.packed.layout.size
    assert planB.route == "paged" and grown == lay.size + per_row * count
    log(f"[F.B flip] {count} Cast inserts ({per_row} int32 words a row) take "
        f"B's arena from {lay.size} to {grown} int32, over draw_limit "
        f"{limit}: route fused -> {planB.route}, as a fresh plan's")
    back = {"Cast": {"delete": np.arange(n_cast, n_cast + count)}}
    current["B"], _ = step("F.B back", tabB, engB, back, keysF)
    assert planB.route == "fused" and planB.shred.packed.layout.size == lay.size
    log(f"[F.B back] deleting them: arena {lay.size} int32, route "
        f"{planB.route}, as a fresh plan's")
    e2e["route_flip_B"] = {"inserts": count, "words_a_row": per_row,
                           "arena": [lay.size, grown], "draw_limit": limit}
    if on_card:
        assert launches["F.B flip"]["fused_sample"] == len(keysF)
        assert launches["F.B flip"]["fused_draw"] == 0
        assert launches["F.B back"]["fused_draw"] == len(keysF)

    # -- the CSR index at A (an engine of rep 'csr' on A's snapshot) ----------
    _, engA, planA = configs["A"]
    pol = engA.kernel_policy
    engCSR = QueryEngine(engA.db, rep="csr", device=device,
                         kernel_policy=pol)
    fullA = engA.full_join(q)
    fullA_csr = main_path("F.CSR", lambda: engCSR.full_join(q))
    for v, col in fullA.items():
        assert torch.equal(fullA_csr[v], col), ("F.CSR", v)
    del fullA, fullA_csr
    csr_shred = engCSR.compile(q).shred
    assert csr_shred.rep == "csr" and engCSR.compile(q).rep_default == "csr"
    n_edges = len(csr_shred.root.nodes()) - 1
    nA = planA.join_size
    posA = torch.arange(nA, dtype=torch.int64, device=device)
    # every ascending position through the caching walk
    cached = main_path("F.CSR cached", lambda: probe.csr_get_rows_cached(
        csr_shred, posA, pol))
    for name, rows in probe.csr_get_rows(csr_shred, posA, pol).items():
        assert torch.equal(cached[name], rows), ("F.CSR cached", name)
    del cached
    # One per-node draw's positions (of an earlier snapshot: positions of
    # the current join all the same), through both GETs of this snapshot.
    c = int(smpA.count)
    posD = torch.clamp(smpA.positions[:c], max=nA - 1)
    got = probe.csr_get_rows(csr_shred, posD, pol)
    want = probe.usr_get_rows(planA.shred, posD, pol)
    for name, rows in want.items():
        assert torch.equal(got[name], rows), ("F.CSR", name)
    del got, want
    if on_card:
        assert launches["F.CSR"]["bsearch_probe"] == 1
        assert launches["F.CSR"]["tree_probe"] == 0
        assert launches["F.CSR"]["csr_walk"] == n_edges
        assert launches["F.CSR cached"]["csr_walk_cached"] == n_edges
        assert launches["F.CSR cached"]["csr_walk"] == 0

    # The walk kernel against its plain versions on each edge's operands as
    # the GET computes them: the full join's positions and the draw's.
    edges_full = csr_walks(probe, cw_mod, csr_shred, posA, pol)
    edges_draw = csr_walks(probe, cw_mod, csr_shred, posD, pol)
    errs["csr_walk"] = errs["csr_walk_cached"] = 0.0
    walks = {}
    for label, edges in (("full join", edges_full), ("draw", edges_draw)):
        for e in edges:
            plain = cw_mod.csr_walk_plain(e.child.weight, e.child.nxt, e.hd,
                                          e.idx)
            tiles, model = {}, {}
            crow, crem = cw_mod.csr_walk_cached(e.child.weight, e.child.nxt,
                                                e.hd, e.idx, stats=tiles)
            mrow, mrem = cw_mod.csr_walk_cached_tiled(
                e.child.weight, e.child.nxt, e.hd, e.idx, stats=model)
            for a, b, k in ((e.row, plain[0], "csr_walk"),
                            (e.rem, plain[1], "csr_walk"),
                            (crow, e.row, "csr_walk_cached"),
                            (crem, e.rem, "csr_walk_cached"),
                            (mrow, e.row, "csr_walk_cached"),
                            (mrem, e.rem, "csr_walk_cached")):
                errs[k] = max(errs[k], max_abs_err(a, b))
            assert tiles == model, (label, e.name, tiles, model)
            steps = csr_steps(e, cached=False)
            csteps = csr_steps(e, cached=True)
            walks[(label, e.name)] = {
                "probes": e.hd.numel(), "longest_chain": e.longest_chain,
                "longest_run": longest_run(e.hd),
                "steps": int(steps.sum()), "cached_steps": int(csteps.sum()),
                "runs": tiles}
            del plain, crow, crem, mrow, mrem, steps, csteps
    assert errs["csr_walk"] == 0.0 and errs["csr_walk_cached"] == 0.0, errs
    # A skewed edge: one head of SKEW_ROWS rows (a key a few thousand child
    # rows share) among A-like chains, probed at every offset of its chain
    # in ascending order, so that its run spans many tiles, each restarting
    # from the head; both kernels against the plain walk, the caching
    # kernel's runs against the tile model's.
    skew = skewed_edge(device, args.seed + 23)
    plain = cw_mod.csr_walk_plain(*skew)
    tiles, model = {}, {}
    crow, crem = cw_mod.csr_walk_cached(*skew, stats=tiles)
    mrow, mrem = cw_mod.csr_walk_cached_tiled(*skew, stats=model)
    wrow, wrem = cw_mod.csr_walk(*skew)
    for a, b, k in ((wrow, plain[0], "csr_walk"), (wrem, plain[1], "csr_walk"),
                    (crow, plain[0], "csr_walk_cached"),
                    (crem, plain[1], "csr_walk_cached"),
                    (mrow, plain[0], "csr_walk_cached"),
                    (mrem, plain[1], "csr_walk_cached")):
        errs[k] = max(errs[k], max_abs_err(a, b))
    assert tiles == model, ("skewed edge", tiles, model)
    walks[("skewed", f"one head of {SKEW_ROWS} rows")] = {
        "probes": skew[2].numel(), "longest_chain": SKEW_ROWS,
        "longest_run": longest_run(skew[2]), "runs": tiles}
    assert errs["csr_walk"] == 0.0 and errs["csr_walk_cached"] == 0.0, errs
    del plain, crow, crem, mrow, mrem, wrow, wrem
    # the cached plain version (a host loop) on the draw's positions
    t0 = time.perf_counter()
    plain_c = [cw_mod.csr_walk_cached_plain(e.child.weight, e.child.nxt,
                                            e.hd, e.idx) for e in edges_draw]
    cached_plain_ms = (time.perf_counter() - t0) * 1e3
    for e, (r, m) in zip(edges_draw, plain_c):
        errs["csr_walk_cached"] = max(errs["csr_walk_cached"],
                                      max_abs_err(r, e.row),
                                      max_abs_err(m, e.rem))
    assert errs["csr_walk_cached"] == 0.0, errs
    del plain_c
    e2e["csr_walks"] = {f"{k[0]}: {k[1]}": v for k, v in walks.items()}
    log(f"[F.CSR] full_join(rep='csr') at A equals the USR full join bit for "
        f"bit ({nA} rows); csr_get_rows_cached on all {nA} positions equals "
        f"csr_get_rows; csr_get_rows on one per-node draw's {c} positions "
        f"equals usr_get_rows; csr_walk equals csr_walk_plain, and "
        f"csr_walk_cached and csr_walk_cached_tiled equal csr_walk (and "
        f"csr_walk_cached_plain on the draw's), bit for bit on every edge of "
        f"both and on the skewed edge; the kernel's runs (staged, fallen "
        f"back, of one probe) equal the tile model's: "
        + "; ".join(f"{k[0]} {k[1]}: {v}" for k, v in walks.items()))

    # -- times -----------------------------------------------------------------
    # The walk kernels by CUDA events: csr_walk at the full join (the
    # engine's CSR GET), csr_walk_cached at the draw's sorted positions (its
    # caller's use: the paper's caching GET of a sample); each edge's
    # launch, a call all edges. Bound: each probe's operands read and
    # results written once, 12 bytes a chain link its walk passes and the
    # weight of the row it stops at, at 3.35 TB/s.
    def walk_call(fn, edges):
        return lambda: [fn(e.child.weight, e.child.nxt, e.hd, e.idx)
                        for e in edges]

    for name, fn, plain_fn, edges, cached_flag in (
            ("csr_walk", cw_mod.csr_walk, cw_mod.csr_walk_plain, edges_full,
             False),
            ("csr_walk_cached", cw_mod.csr_walk_cached, None, edges_draw,
             True)):
        call[name] = walk_call(fn, edges)
        ms = timed(call[name], args.reps, device)
        plain_ms = (timed(walk_call(plain_fn, edges), 1, device)
                    if plain_fn is not None else cached_plain_ms)
        nbytes = sum(24 * e.hd.numel() + 12 * int(csr_steps(e, cached_flag)
                                                  .sum())
                     + 8 * int((e.row >= 0).sum()) for e in edges)
        b_ms, b_by = bound(nbytes, 0)
        krows.append((name, ("src/repro/core/probe.py:403" if not cached_flag
                            else "src/repro/core/probe.py:434"),
                     ms, plain_ms, b_ms, b_by, None))
        if on_card:
            dev_ms[name] = device_ms(call[name])
    e2e["csr_walk_cached_full_join_ms"] = timed(
        walk_call(cw_mod.csr_walk_cached, edges_full), args.reps, device)
    # the plain walk at the draw's positions: what the cache has to beat;
    # and a yardstick for both: one torch gather of `weight` and `nxt` at
    # the chain rows the reference's caching scan passes there, the random
    # row fetches that no walk of these probes avoids
    e2e["csr_walk_draw_ms"] = timed(walk_call(cw_mod.csr_walk, edges_draw),
                                    args.reps, device)
    e2e["csr_walk_cached_draw_ms"] = krows[-1][2]
    walked = [(e.child, walked_rows(e)) for e in edges_draw]
    e2e["csr_walked_rows"] = sum(int(r.numel()) for _, r in walked)
    e2e["csr_walked_rows_gather_ms"] = timed(
        lambda: [(ch.weight[r], ch.nxt[r]) for ch, r in walked], args.reps,
        device)
    del edges_full, edges_draw, walked
    e2e["csr_get_rows_A_ms"] = timed(
        lambda: probe.csr_get_rows(csr_shred, posA, pol), args.reps, device)
    e2e["csr_get_rows_cached_A_ms"] = timed(
        lambda: probe.csr_get_rows_cached(csr_shred, posA, pol), args.reps,
        device)
    e2e["usr_get_rows_A_ms"] = timed(
        lambda: probe.get_rows(planA.shred, posA, planA.rep_default, pol),
        args.reps, device)
    # -- times -----------------------------------------------------------------
    # CUDA events around warm calls (each ends in host reads). A fresh churn
    # of Cast a configuration: it keeps the row counts, so it applies again
    # on every snapshot it produces.
    e2e["full_join_csr_A_ms"] = timed(lambda: engCSR.full_join(q), args.reps,
                                      device)
    e2e["full_join_usr_A_ms"] = timed(lambda: engA.full_join(q), args.reps,
                                      device)
    log(f"[time] F.CSR: full_join(rep='csr') at A "
        f"{e2e['full_join_csr_A_ms']:.3f} ms, USR "
        f"{e2e['full_join_usr_A_ms']:.3f} ms; the GET of all {nA} "
        f"positions: csr_get_rows {e2e['csr_get_rows_A_ms']:.3f} ms, "
        f"csr_get_rows_cached {e2e['csr_get_rows_cached_A_ms']:.3f} ms, "
        f"USR ({planA.rep_default}) {e2e['usr_get_rows_A_ms']:.3f} ms; "
        f"csr_walk_cached over the full join's edges "
        f"{e2e['csr_walk_cached_full_join_ms']:.3f} ms; at the draw's "
        f"positions csr_walk_cached {e2e['csr_walk_cached_draw_ms']:.4f} ms, "
        f"csr_walk {e2e['csr_walk_draw_ms']:.4f} ms, a gather of the "
        f"{e2e['csr_walked_rows']} chain rows the caching scan passes "
        f"{e2e['csr_walked_rows_gather_ms']:.4f} ms; longest chain and "
        f"longest run of equal heads by edge: "
        + "; ".join(f"{k}: chain {v['longest_chain']}, run "
                    f"{v['longest_run']}" for k, v in e2e["csr_walks"].items()))
    del engCSR, csr_shred, posA, posD
    for label in "ABC":
        _, eng, _ = configs[label]
        plan = eng.compile(q)
        pol = eng.kernel_policy
        reps = 3 if label == "A" else args.reps
        delta = DeltaBatch.of(**churn_spec(current[label], "Cast", 0.005,
                                           rng))
        db0, base = eng.db, plan.shred
        db1 = db0.apply(delta)
        key = threefry.key(19_200)
        t = {"delta_rows": delta.size()}
        # both paths given the new snapshot, as apply_delta gives them
        t["reshred_incremental_ms"] = timed(
            lambda: reshred_incremental(base, db0, q, delta, pol, db1), reps,
            device)
        t["build_shred_ms"] = timed(
            lambda: build_shred(db1, q, rep=base.rep, policy=pol), reps,
            device)
        if on_card and args.profile and label == "A":
            e2e["profile_reshred_A"] = profile_window(
                lambda: reshred_incremental(base, db0, q, delta, pol, db1),
                "reshred_incremental(A)", t["reshred_incremental_ms"])
            e2e["profile_build_A"] = profile_window(
                lambda: build_shred(db1, q, rep=base.rep, policy=pol),
                "build_shred(A)", t["build_shred_ms"])
        del db1, base
        t["apply_delta_draw_ms"] = timed(
            lambda: (eng.apply_delta(delta), eng.sample(q, key).count),
            reps, device)
        t["rebind_draw_ms"] = timed(
            lambda: (eng.rebind(eng.db.apply(delta)),
                     eng.sample(q, key).count), reps, device)
        e2e[f"updates_{label}"] = t
        log(f"[time] F.{label} (delta of {t['delta_rows']} rows, Cast): "
            f"reshred_incremental {t['reshred_incremental_ms']:.3f} ms, "
            f"build_shred {t['build_shred_ms']:.3f} ms; apply_delta + draw "
            f"{t['apply_delta_draw_ms']:.3f} ms, rebind + draw "
            f"{t['rebind_draw_ms']:.3f} ms")
    return launches, e2e, krows


@dataclasses.dataclass
class CsrEdge:
    """One edge's walk of the CSR GET: its operands as ``csr_get_rows``
    computes them (heads ``hd``, offsets ``idx``, and the parents' run
    ``start`` and ``length`` in the child's sorted order) and the walk
    kernel's ``row`` and ``rem``."""

    name: str
    child: object
    hd: object
    idx: object
    start: object
    length: object
    row: object
    rem: object

    @property
    def longest_chain(self) -> int:
        return int(self.length.max()) if self.length.numel() else 0


def csr_walks(probe, cw_mod, shred, pos, policy) -> list:
    """Every edge's walk of ``csr_get_rows(shred, pos)``, in its order."""
    import torch

    rows, local = probe._root_locate(shred, pos, policy)
    out = []

    def sub(node, rows, local):
        for ci, child in enumerate(node.children):
            w_safe = torch.clamp(node.child_w[ci][rows], min=1)
            idx = torch.remainder(local, w_safe)
            local = torch.div(local, w_safe, rounding_mode="floor")
            hd = node.child_hd[ci][rows]
            row, rem = cw_mod.csr_walk(child.weight, child.nxt, hd, idx)
            out.append(CsrEdge(f"{node.name} -> {child.name}", child, hd, idx,
                               node.child_start[ci][rows],
                               node.child_len[ci][rows], row, rem))
            sub(child, torch.clamp(row, min=0), rem)

    sub(shred.root, rows, local)
    return out


def csr_steps(e: CsrEdge, cached: bool):
    """The chain links each probe's walk passes: the rank of the row it
    stops at within its run (the chain is the run's sorted order; a walk
    off the chain passed the whole run), less, for the caching walk, the
    rank where the previous probe of the same head stopped when it
    resumes from there (its offset at least what that walk consumed)."""
    import torch

    perm = e.child.perm.long()
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device)
    at = torch.clamp(e.row, min=0).long()
    rank = torch.where(e.row >= 0, inv[at] - e.start, e.length.long())
    if not cached:
        return rank
    used = e.idx - e.rem
    same = torch.zeros_like(e.hd, dtype=torch.bool)
    same[1:] = (e.hd[1:] == e.hd[:-1]) & (e.idx[1:] >= used[:-1])
    prev = torch.zeros_like(rank)
    prev[1:] = rank[:-1]
    return rank - torch.where(same, prev, 0)


def walked_rows(e: CsrEdge):
    """The child rows the reference's caching scan passes on edge ``e``,
    link after link: a probe walks its run's chain (the run's sorted
    order) from the rank where the previous probe of its head stopped,
    when it resumes, else from the head, to the rank where it stops."""
    import torch

    passed = csr_steps(e, cached=True)
    stop = csr_steps(e, cached=False)
    first = stop - passed
    at = torch.repeat_interleave(torch.arange(passed.numel(),
                                              device=passed.device), passed)
    offs = torch.cumsum(passed, 0) - passed
    k = torch.arange(at.numel(), device=at.device) - offs[at]
    return e.child.perm.long()[e.start[at].long() + first[at] + k]


SKEW_ROWS = 6000  # the skewed edge's rows on one head


def skewed_edge(device, seed: int):
    """A CSR edge with a skewed key: 400,000 child rows (weights 0-3, a
    tenth 0) in same-key chains over 30,000 keys, SKEW_ROWS of them on key
    0; probes in ascending order: a run at every offset of key 0's chain
    (one run over many tiles), then one to three probes on each of 20,000
    other keys and empty heads. Returns (weight, nxt, hd, idx)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows, keys = 400_000, 30_000
    key = rng.integers(1, keys, rows)
    key[rng.choice(rows, SKEW_ROWS, replace=False)] = 0
    weight = rng.integers(0, 4, rows) * (rng.random(rows) >= 0.1)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    nxt = np.full(rows, -1, np.int32)
    same = ks[1:] == ks[:-1]
    nxt[order[:-1][same]] = order[1:][same]
    first = np.r_[True, ~same]
    heads = np.full(keys, -1, np.int32)
    heads[ks[first]] = order[first]
    total = np.bincount(key, weights=weight, minlength=keys).astype(np.int64)
    hd = [np.full(int(total[0]) + 1, heads[0], np.int32)]
    idx = [np.arange(int(total[0]) + 1, dtype=np.int64)]
    for k in np.sort(rng.choice(np.arange(1, keys + 500), 20_000,
                                replace=False)):
        m = int(rng.integers(1, 4))
        h = heads[k] if k < keys else -1
        top = int(total[k]) + 1 if k < keys else 1
        hd.append(np.full(m, h, np.int32))
        idx.append(np.sort(rng.integers(0, top, m)))
    to = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (to(weight.astype(np.int64)), to(nxt), to(np.concatenate(hd)),
            to(np.concatenate(idx)))


def longest_run(hd) -> int:
    """The longest run of equal heads: the most probes one thread of the
    caching walk serves."""
    import torch

    if hd.numel() == 0:
        return 0
    starts = torch.nonzero(torch.cat([
        torch.ones(1, dtype=torch.bool, device=hd.device),
        hd[1:] != hd[:-1]])).reshape(-1)
    ends = torch.cat([starts[1:], torch.tensor([hd.numel()],
                                               device=hd.device)])
    return int((ends - starts).max())


def serve_stream(shapes, n: int, updates: int, spec_fn, seed0: int):
    """``n`` draws over ``shapes`` in turn (seeds from ``seed0``) with
    ``updates`` update requests (each a fresh ``spec_fn()`` delta) spread
    evenly through them."""
    from repro_torch.core import DeltaBatch
    from repro_torch.launch.fleet import JoinSampleRequest, UpdateRequest

    reqs = [JoinSampleRequest(query=shapes[i % len(shapes)], seed=seed0 + i)
            for i in range(n)]
    every = n // (updates + 1)
    for u in range(updates, 0, -1):
        reqs.insert(u * every, UpdateRequest(DeltaBatch.of(**spec_fn())))
    return reqs


def served_draws(done) -> list:
    from repro_torch.launch.fleet import JoinSampleRequest

    return [r for r in done if isinstance(r, JoinSampleRequest)]


def serving_profiles(args) -> dict:
    """Phase G's ``--profile`` windows, in a fresh process of this script
    (``--serving-profiles``): run after phases A-F in the same process,
    the profiler recorded no event of the draw kernels' library (their
    launches, key uploads and memsets), which a fresh process records.
    Returns the windows."""
    cmd = [sys.executable, str(Path(__file__).resolve()),
           "--serving-profiles", "--seed", str(args.seed),
           "--serving-title-rows", str(args.serving_title_rows),
           "--corpus-docs", str(args.corpus_docs),
           "--corpus-seq", str(args.corpus_seq)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    for line in out.stdout.splitlines():
        if not line.startswith("PROFILES "):
            log(line)
    if out.returncode:
        raise RuntimeError(f"serving profiles failed: {out.stderr[-2000:]}")
    line = next(x for x in out.stdout.splitlines()
                if x.startswith("PROFILES "))
    return json.loads(line[len("PROFILES "):])


def run_serving_profiles(args, device) -> dict:
    """The windows of ``serving_profiles``: a batcher flush of 32 draws of
    the three-way join at B, and a steady window of 32 pipeline steps
    (its first step dispatching the next window) over the corpus, after
    128 steps."""
    from repro_torch.core import Atom, Database, JoinQuery
    from repro_torch.data import PoissonJoinSource, make_corpus_db
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import build
    from repro_torch.launch.fleet import JoinSampleRequest, MicroBatcher

    build.build_all()
    q = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                   Atom.of("Cast", "t", "person"),
                   Atom.of("Comp", "t", "comp")), prob_var="p")
    eng = QueryEngine(Database.from_columns(
        make_tables(args.seed + 1, args.serving_title_rows), device=device),
        device=device)

    def flush():
        mb = MicroBatcher(eng, max_batch=32, max_wait_ms=1e9)
        for i in range(32):
            mb.submit(JoinSampleRequest(query=q, seed=7000 + i))
    out = {"flush_B": profile_window(
        flush, "G.B batcher flush of 32 (Title |><| Cast |><| Comp)",
        wall_ms(flush, device))}
    del eng
    corpus = make_corpus_db(args.corpus_docs, 4096, args.corpus_seq, 32_000,
                            seed=args.seed, device=device)
    src = PoissonJoinSource(corpus, args.corpus_seq, 32, seed=args.seed,
                            window=32, depth=2)
    state = {"s": 0}

    def window():
        for t in range(state["s"], state["s"] + 32):
            src.batch_at(t)
        state["s"] += 32
    for _ in range(4):
        window()
    out["pipeline"] = profile_window(
        window, "G.pipeline steady window of 32 steps",
        wall_ms(window, device))
    return out


def run_every_card(args) -> dict:
    """``--every-card``: the batched draws on each visible card in turn,
    card 0 first, each held bit for bit against its plain version on that
    card: ``fused_draw_batch`` of Title |><| Cast and of the three-way join
    at B (two shared memory sizes) and ``fused_sample_batch`` at C, 32 keys
    each. A card's first launch comes after other cards' launches, so a
    dynamic shared memory limit set in one card's context only cannot pass
    for another's. Returns each card's check."""
    import torch

    from repro_torch.core import Atom, Database, JoinQuery
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import build, threefry
    from repro_torch.kernels import fused_draw as fd

    build.build_all()
    q = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                   Atom.of("Cast", "t", "person"),
                   Atom.of("Comp", "t", "comp")), prob_var="p")
    tabB = make_tables(args.seed + 1, args.serving_title_rows)
    tabC = make_tables(args.seed + 2, args.paged_title_rows)
    keys = threefry.keys(2000, args.draws)
    out = {}
    for c in range(torch.cuda.device_count()):
        device = torch.device("cuda", c)
        torch.cuda.set_device(device)
        checks = []
        for label, tables, query, walk in (
                ("B, Title |><| Cast", tabB,
                 JoinQuery(q.atoms[:2], prob_var="p"), True),
                ("B", tabB, q, True), ("C", tabC, q, False)):
            plan = QueryEngine(Database.from_columns(tables, device=device),
                               device=device).compile(query)
            pk = plan.shred.packed
            kw = dict(method="exprace", cap=plan.default_capacity(),
                      acap=plan.arrival_capacity())
            if walk:
                got = fd.fused_draw_batch(pk.arena, keys, plan.draw_params,
                                          layout=pk.layout, **kw)
                want = fd.fused_draw_batch_plain(
                    pk.arena, keys, plan.draw_params, layout=pk.layout, **kw)
            else:
                got = fd.fused_sample_batch(keys, plan.draw_params, **kw)
                want = fd.fused_sample_batch_plain(keys, plan.draw_params,
                                                   **kw)
            assert got[-2].device == device
            err = max(max_abs_err(g, w) for g, w in zip(got, want))
            smem = fd.grid(walk, kw["acap"], kw["cap"], plan.w.numel(),
                           len(keys), layout=pk.layout)[3]
            log(f"[cards] cuda:{c} "
                f"{'fused_draw_batch' if walk else 'fused_sample_batch'} at "
                f"{label} ({len(keys)} keys, {smem} bytes of dynamic shared "
                f"memory): vs plain max_abs_err {err}")
            assert err == 0.0, (c, label)
            checks.append({"label": label, "smem": smem, "max_abs_err": err})
        out[f"cuda:{c}"] = checks
    return out


def run_serving(args, device, q, configs, kernels, kernel_policy):
    """Phase G: the serving path and the data plane on the card.

    G.B: a stream of ``--serve-requests`` draws over three shapes (Title,
    Title |><| Cast, Title |><| Cast |><| Comp) at B's tables with four
    Cast churns (phase F's) spread through it, ``max_batch`` 32 and
    ``max_wait_ms`` 2: through ``serve_join_samples`` on one engine (the
    baseline), then through ``Fleet(replicas=4, clock='real')`` with the
    main shape's home replica crashed mid-stream. Every fleet draw's
    (count, overflow) per (seed, version) equals the baseline's, nothing
    is lost or served twice; 8 requests a shape, served with
    ``collect_rows=True``, equal ``engine.sample`` row for row; the cache
    shows upgrades and no build after warm-up. G.C and G.A: the paged and
    per-node routes through one engine's batcher (``max_batch`` 8; one
    update at A), each request against the single draw at its version.
    G.pipeline: ``make_corpus_db`` (``--corpus-docs`` documents, 4,096
    clusters, ``--corpus-seq`` tokens each, vocabulary 32,000) through
    ``PoissonJoinSource(batch=32, window=32, depth=2)`` with two
    ``corpus_delta`` barriers (1,000 documents in and 1,000 out, at steps
    40 and 80): the route, the versions, batches 0-127 against a fresh
    source's taken in shuffled order within each snapshot, the counters,
    and a ``Prefetcher``'s batches. G.cli: ``serve.main`` in join mode
    with 4 replicas and 4 updates. Each main path counts its launches
    (zeroed just before, read just after). Returns the launches and the
    times."""
    import numpy as np
    import torch

    from repro_torch.core import Atom, Database, JoinQuery
    from repro_torch.data import (PoissonJoinSource, Prefetcher,
                                  corpus_delta, make_corpus_db)
    from repro_torch.engine import QueryEngine, query_fingerprint
    from repro_torch.kernels import threefry
    from repro_torch.launch import metrics, serve
    from repro_torch.launch.fleet import (DOWN, Fleet, JoinSampleRequest,
                                          serve_join_samples)

    on_card = device.type == "cuda"
    launches, e2e = {}, {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def main_path(label, fn):
        for f in kernels.values():
            f.launches = 0
        out = fn()
        sync()
        launches[label] = {k: f.launches for k, f in kernels.items()}
        log(f"[{label}] launches " + str({k: v for k, v in
                                          launches[label].items() if v}))
        return out

    def engine(db):
        return QueryEngine(db, device=device, kernel_policy=kernel_policy)

    def latency(label, draws, wall_s):
        out = dict(metrics.latency_summary([r.latency_s for r in draws]),
                   draws=len(draws), wall_ms=wall_s * 1e3,
                   draws_per_s=len(draws) / wall_s)
        log(f"[time] {label}: {len(draws)} draws in {wall_s * 1e3:.1f} ms: "
            f"{out['draws_per_s']:.1f} draws/s, latency p50 "
            f"{out['p50_ms']:.3f} ms, p99 {out['p99_ms']:.3f} ms, max "
            f"{out['max_ms']:.3f} ms (metrics.percentile, nearest rank); "
            f"slowest (seed, ms): " + ", ".join(
                f"({r.seed}, {r.latency_s * 1e3:.3f})" for r in sorted(
                    draws, key=lambda r: -r.latency_s)[:3]))
        return out

    def check_single(label, eng, reqs, rows=False):
        """Each request against ``eng.sample`` under its key, ``eng`` at
        the requests' version."""
        for r in reqs:
            want = eng.sample(r.query, threefry.key(r.seed))
            assert (r.count, r.overflow) == (int(want.count),
                                             bool(want.overflow)), \
                (label, r.seed, r.count, int(want.count))
            if rows:
                assert set(r.rows) == set(want.columns), label
                for c, col in want.columns.items():
                    assert np.array_equal(r.rows[c],
                                          col[: r.count].cpu().numpy()), \
                        (label, r.seed, c)

    title = JoinQuery((Atom.of("Title", "t", "kind", "p"),), prob_var="p")
    title_cast = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                            Atom.of("Cast", "t", "person")), prob_var="p")
    shapes = (title, title_cast, q)

    # -- G.B: the batcher, then the fleet ----------------------------------------
    tabB = make_tables(args.seed + 1, args.serving_title_rows)
    dbB = Database.from_columns(tabB, device=device)
    n = args.serve_requests

    def stream():
        churn = np.random.default_rng(args.seed + 21)
        return serve_stream(shapes, n, 4,
                            lambda: churn_spec(tabB, "Cast", 0.005, churn),
                            5000)

    engB = engine(dbB)
    routes = [engB.compile(s).route for s in shapes]
    for s in shapes:  # warm-up: one index and one plan a shape
        engB.sample(s, threefry.key(0))
    st0 = engB.stats.snapshot()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    done = main_path("G.B batcher", lambda: serve_join_samples(
        engB, stream(), max_batch=32, max_wait_ms=2.0))
    e2e["batcher_B"] = latency("G.B batcher", served_draws(done),
                               time.perf_counter() - t0)
    base = {(r.seed, r.db_version): (r.count, r.overflow)
            for r in served_draws(done)}
    assert len(base) == n and engB.db.version == 4, (len(base), engB.db.version)
    st = engB.stats
    assert (st.shred_builds, st.plan_misses) == (st0.shred_builds,
                                                 st0.plan_misses), st
    assert st.shred_upgrades >= 4 and st.plan_upgrades >= 4, st
    log(f"[G.B batcher] {n} draws over {len(shapes)} shapes (routes "
        f"{routes}) and 4 updates: after warm-up {st.shred_upgrades - st0.shred_upgrades} "
        f"shred and {st.plan_upgrades - st0.plan_upgrades} plan upgrades, "
        f"0 builds, 0 plan misses ({st})")
    if on_card:
        assert launches["G.B batcher"]["fused_draw_batch"] > 0
        assert launches["G.B batcher"]["fused_draw"] == 0
    # 8 requests a shape, their rows to the host, at the engine's version
    reqs = [JoinSampleRequest(query=shapes[i % 3], seed=9000 + i)
            for i in range(24)]
    serve_join_samples(engB, reqs, max_batch=32, collect_rows=True)
    check_single("G.B rows", engB, reqs, rows=True)
    log("[G.B batcher] 24 requests (8 a shape) with collect_rows: rows "
        "equal engine.sample row for row")

    fleet = Fleet(dbB, replicas=4, max_batch=32, max_wait_ms=2.0,
                  max_inflight=4 * n, clock="real", retry_timeout_s=30.0,
                  kernel_policy=kernel_policy)
    victim = fleet.router._route(query_fingerprint(q))
    for i, s in enumerate(shapes):  # warm-up: each shape on its home
        assert fleet.submit(JoinSampleRequest(query=s, seed=i)) is None
    while fleet.router.inflight:
        fleet.pump()
    fleet.take_completed()
    stf0 = fleet.stats()

    def serve_fleet_stream():
        done = []
        for i, r in enumerate(stream()):
            assert fleet.submit(r) is None, "rejected"
            done += fleet.take_completed()
            if i + 1 == (n + 4) // 2:
                fleet.crash(victim)
                done += fleet.take_completed()
        return done + fleet.drain()

    t0 = time.perf_counter()
    done = main_path("G.B fleet", serve_fleet_stream)
    draws = served_draws(done)
    e2e["fleet_B"] = latency("G.B fleet", draws, time.perf_counter() - t0)
    assert len(draws) == n and len({id(r) for r in draws}) == n, \
        "a request lost or served twice"
    bad = [r.seed for r in draws
           if base.get((r.seed, r.db_version)) != (r.count, r.overflow)]
    assert not bad, f"fleet != single engine for seeds {bad[:8]}"
    rep = next(r for r in fleet.replicas if r.name == victim)
    assert rep.state == DOWN and victim not in fleet.router.drained
    stf = fleet.stats()
    assert stf.shred_upgrades > stf0.shred_upgrades, stf
    e2e["fleet_B"].update(retries=fleet.router.retries, crashed=victim,
                          stats=dataclasses.asdict(stf))
    log(f"[G.B fleet] 4 replicas, {victim} (home of the 3-way join) crashed "
        f"after request {(n + 4) // 2}: {n} draws equal the batcher's per "
        f"(seed, version), none lost or served twice; retries "
        f"{fleet.router.retries}; log head {fleet.log.head}; builds after "
        f"warm-up {stf.shred_builds - stf0.shred_builds} (the crashed "
        f"replica's shapes on their next home), upgrades "
        f"{stf.shred_upgrades - stf0.shred_upgrades} ({stf})")
    if on_card:
        peak = torch.cuda.max_memory_allocated(device)
        e2e["peak_device_bytes_serving_B"] = int(peak - held)
        log(f"[memory] G.B batcher and fleet (4 replicas' snapshots and "
            f"engines on one card): peak {peak / 2**30:.3f} GiB, of which "
            f"{held / 2**30:.3f} GiB held by earlier phases before it: "
            f"{(peak - held) / 2**30:.3f} GiB its own")
        assert launches["G.B fleet"]["fused_draw_batch"] > 0
    del fleet, engB

    # -- G.C and G.A: the paged and per-node routes, one engine each ----------
    tabC = make_tables(args.seed + 2, args.paged_title_rows)
    engC = engine(Database.from_columns(tabC, device=device))
    assert engC.compile(q).route == "paged"
    # warm-up: the stream once (indexes, plans, each batch size's buffers)
    serve_join_samples(engC, serve_stream(shapes, 64, 0, None, 6000),
                       max_batch=8, max_wait_ms=2.0)
    reqsC = serve_stream(shapes, 64, 0, None, 6000)
    t0 = time.perf_counter()
    main_path("G.C batcher", lambda: serve_join_samples(
        engC, reqsC, max_batch=8, max_wait_ms=2.0, collect_rows=True))
    e2e["batcher_C"] = latency("G.C batcher", reqsC, time.perf_counter() - t0)
    check_single("G.C", engC, reqsC, rows=True)
    log(f"[G.C batcher] 64 draws over {len(shapes)} shapes (routes "
        f"{[engC.compile(s).route for s in shapes]}): count, overflow and "
        f"rows equal engine.sample")
    if on_card:
        assert launches["G.C batcher"]["fused_sample_batch"] > 0
        assert launches["G.C batcher"]["tree_probe_paged"] > 0
    del engC

    tabA, engA, _ = configs["A"]
    assert engA.compile(q).route == "pernode"
    churnA = np.random.default_rng(args.seed + 22)
    reqsA = serve_stream((q,), 16, 1,
                         lambda: churn_spec(tabA, "Cast", 0.005, churnA),
                         7000)
    before = reqsA[:8]
    want0 = []
    for r in before:
        w = engA.sample(q, threefry.key(r.seed))
        want0.append((int(w.count), bool(w.overflow)))
    del w
    v0 = engA.db.version
    t0 = time.perf_counter()
    main_path("G.A batcher", lambda: serve_join_samples(
        engA, reqsA, max_batch=8, max_wait_ms=2.0))
    drawsA = served_draws(reqsA)
    e2e["batcher_A"] = latency("G.A batcher", drawsA,
                               time.perf_counter() - t0)
    assert [(r.count, r.overflow) for r in before] == want0
    assert all(r.db_version == v0 for r in before)
    after = drawsA[8:]
    assert all(r.db_version == v0 + 1 for r in after)
    check_single("G.A", engA, after)
    log(f"[G.A batcher] 16 per-node draws, 8 at version {v0} and 8 after a "
        f"Cast churn at {v0 + 1}: count and overflow equal engine.sample")
    if on_card:
        assert launches["G.A batcher"]["tree_probe"] > 0
        assert launches["G.A batcher"]["bsearch_probe"] > 0

    # -- G.pipeline: the Poisson-join training-data source --------------------
    nd, seq = args.corpus_docs, args.corpus_seq
    t0 = time.perf_counter()
    corpus = make_corpus_db(nd, 4096, seq, 32_000, seed=args.seed,
                            device=device)
    sync()
    e2e["corpus_s"] = time.perf_counter() - t0
    log(f"[G.pipeline] corpus: {nd} documents x {seq} tokens "
        f"({nd * seq} int64, {nd * seq * 8 / 1e9:.2f} GB on the device), "
        f"4,096 clusters: numpy generation and upload {e2e['corpus_s']:.1f} s")
    pick = np.random.default_rng(args.seed + 23)
    snap, deltas = corpus, []
    for i, at in enumerate((40, 80)):
        d = corpus_delta(snap, seq, 32_000, insert=1000, seed=300 + i,
                         retire=pick.choice(snap.relations["Doc"].num_rows,
                                            1000, replace=False))
        deltas.append((at, d))
        if i == 0:
            snap = snap.apply(d)
    del snap

    def source(depth=2):
        return PoissonJoinSource(corpus, seq, 32, seed=args.seed, window=32,
                                 depth=depth, deltas=deltas,
                                 kernel_policy=kernel_policy)

    t0 = time.perf_counter()
    src = source()
    sync()
    plan = src.engine.compile(src.query, src._spec)
    lay = plan.shred.packed.layout
    log(f"[G.pipeline] index of Doc |><| ClusterQuality in "
        f"{time.perf_counter() - t0:.2f} s: arena {lay.size} int32, route "
        f"{plan.route}, cap {src.cap}, E[k] {plan.expected_k():.1f}")
    if lay.size <= src.engine.kernel_policy.draw_limit:
        assert plan.route == "fused", plan.route
    if nd == 1_000_000:
        assert lay.size == 2_012_290 and plan.route == "fused", lay.size
    steps = 128

    def consume(s, k):
        return [src.batch_at(t) for t in range(s, s + k)]

    batches = main_path("G.pipeline", lambda: consume(0, steps))
    versions = [b["db_version"] for b in batches]
    assert versions == [0] * 40 + [1] * 40 + [2] * 48, versions
    assert versions == [src.version_at(s) for s in range(steps)]
    wrapped, overflows = src.wrapped, src.overflows
    log(f"[G.pipeline] {steps} batches of 32 x {seq - 1} tokens: versions "
        f"step at 40 and 80; wrapped {wrapped}, overflows {overflows}")
    if on_card:
        assert launches["G.pipeline"]["fused_draw_batch"] > 0

    # steady state, after the barriers: one window (its first step
    # dispatches the next window) and the rest of its steps
    per = {"dispatch_ms": [], "dispatch_host_ms": [], "step_ms": []}
    s = steps
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        src.batch_at(s)
        th = time.perf_counter()  # the host returns: what it waited for
        sync()
        t1 = time.perf_counter()
        consume(s + 1, 31)
        sync()
        t2 = time.perf_counter()
        per["dispatch_host_ms"].append((th - t0) * 1e3)
        per["dispatch_ms"].append((t1 - t0) * 1e3)
        per["step_ms"].append((t2 - t0) * 1e3 / 32)
        s += 32
    e2e["pipeline"] = {"window_dispatch_ms": per["dispatch_ms"],
                       "window_dispatch_host_ms": per["dispatch_host_ms"],
                       "steady_step_ms": per["step_ms"],
                       "wrapped": wrapped, "overflows": overflows,
                       "arena": lay.size, "cap": src.cap}
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)  # noqa: E731
    log(f"[time] G.pipeline steady window (32 steps, its first step "
        f"dispatching the next window of 32 draws), synchronized at its "
        f"end: {fmt(per['step_ms'])} ms a step; the dispatching step "
        f"{fmt(per['dispatch_ms'])} ms to the device's end, of which the "
        f"host is held {fmt(per['dispatch_host_ms'])} ms")

    # a fresh source, each snapshot's steps in shuffled order (without the
    # eager dispatch: at depth 2 a window before a barrier applies it)
    src2 = source(depth=1)
    order = np.concatenate([pick.permutation(np.arange(lo, hi))
                            for lo, hi in ((0, 40), (40, 80), (80, steps))])
    for t in order:
        a, b = batches[t], src2.batch_at(int(t))
        assert a["db_version"] == b["db_version"], t
        for k in ("tokens", "targets", "doc_ids", "sampled_k"):
            assert torch.equal(a[k], b[k]), (t, k)
    del src2
    log(f"[G.pipeline] a fresh source's batches 0-{steps - 1}, shuffled "
        f"within each snapshot: equal (tokens, targets, doc ids, sampled_k, "
        f"db_version)")
    pf = Prefetcher(source(), start_step=0, depth=2)
    try:
        for want in range(48):
            t, b = next(pf)
            assert t == want
            for k in ("tokens", "targets", "doc_ids", "sampled_k"):
                assert torch.equal(batches[t][k], b[k]), (t, k)
    finally:
        pf.stop()
    log("[G.pipeline] Prefetcher (a second thread, on the device's current "
        "stream there: the default stream) yields batches 0-47 equal")
    del pf, src, batches, corpus, deltas

    if on_card and args.profile:
        e2e["profile"] = serving_profiles(args)

    # -- G.cli ---------------------------------------------------------------
    t0 = time.perf_counter()
    main_path("G.cli", lambda: serve.main(
        ["--mode", "join", "--replicas", "4", "--updates", "4",
         "--device", str(device)], kernel_policy=kernel_policy))
    log(f"[G.cli] serve.main --mode join --replicas 4 --updates 4: "
        f"{time.perf_counter() - t0:.1f} s, its checks held")
    return launches, e2e


def run_sharding(args, device, q, configs, kernels, kernel_policy):
    """Phase H: sharded sampling, one process driving a mesh of four
    entries on the one card (``make_mesh((4,), ('data',))``): four real
    shards of the root, each drawn by the shard's own plan on the card
    under ``fold_in(key, s)``.

    H.A at A's snapshot (JOB-IMDB, every title): ``full_join(mesh=)``
    equals the single-device full join in order; the shards' join sizes
    sum to the join; ``--keys`` sharded draws (per-node route a shard) are
    rows of the join at their positions and pass the mean-count z-test
    against ``expected_k``; warm calls build nothing; peak device memory
    (children are replicated a shard). H.F at A: a Cast churn (0.5% each
    way; every shard rebuilt) and new p for titles of the last block only
    (one shard rebuilt, three reused), each through ``apply_delta`` on the
    warm sharded plan, whose shards then equal a fresh ``build_stacked``
    array for array. H.B at B's tables (fresh; the fused draw a shard):
    each shard's draw equals one engine's over that shard's database under
    ``fold_in(key, s)``, bit for bit; ``sample_batch`` of 32 keys equals
    32 sharded draws lane by lane; ``MicroBatcher(mesh=)`` over phase G's
    stream equals sharded single draws per (seed, version); ``serve.main
    --devices 4``. Then the times, sharded beside single-device. Each main
    path counts its launches (zeroed just before, read just after).
    Returns the launches and the times."""
    import numpy as np
    import torch

    from repro_torch.core import Atom, Database, DeltaBatch, JoinQuery
    from repro_torch.core import estimate
    from repro_torch.core.distributed import (build_stacked, partition_root,
                                              semijoin_filter)
    from repro_torch.engine import QueryEngine, ShardedPlan
    from repro_torch.kernels import threefry
    from repro_torch.launch import serve
    from repro_torch.launch.fleet import UpdateRequest, serve_join_samples
    from repro_torch.launch.mesh import make_mesh

    on_card = device.type == "cuda"
    launches, e2e = {}, {}
    smi = nvidia_smi_line() if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def main_path(label, fn):
        for f in kernels.values():
            f.launches = 0
        out = fn()
        sync()
        launches[label] = {k: f.launches for k, f in kernels.items()}
        log(f"[{label}] launches " + str({k: v for k, v in
                                          launches[label].items() if v}))
        return out

    def engine(db):
        return QueryEngine(db, device=device, kernel_policy=kernel_policy)

    mesh = make_mesh((4,), ("data",), devices=[device] * 4)

    # -- H.A: JOB-IMDB on four shards -------------------------------------------
    engA = configs["A"][1]
    planA = engA.compile(q)  # phase F's times rebound A's engine
    fullA = engA.full_join(q)
    keysA = [threefry.key(21_000 + s) for s in range(args.keys)]
    st0 = engA.stats.snapshot()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    full, smps = main_path("H.A", lambda: (
        engA.full_join(q, mesh=mesh),
        [engA.sample(q, k, mesh=mesh) for k in keysA]))
    cold_s = time.perf_counter() - t0
    plan = engA.compile_sharded(q, mesh)
    assert isinstance(plan, ShardedPlan) and plan.num_shards == 4, plan
    assert plan.route == "pernode", plan.route
    st = engA.stats
    assert (st.shred_builds, st.plan_misses) == (st0.shred_builds + 1,
                                                 st0.plan_misses + 1), st
    for v, col in fullA.items():
        assert torch.equal(full[v], col), ("H.A", v)
    del full
    assert sum(plan.join_sizes) == plan.join_size == planA.join_size
    counts = [check_sample(smp, fullA, "H.A") for smp in smps]
    del smps
    mean = planA.expected_k()
    sd = float(estimate.sample_std(planA.w, planA.p))
    zA = (float(np.mean(counts)) - mean) / (sd / math.sqrt(len(counts)))
    assert abs(zA) < Z_LIMIT, zA
    assert abs(plan.expected_k() - mean) <= 1e-9 * mean
    st1 = engA.stats.snapshot()
    engA.sample(q, keysA[0], mesh=mesh)
    engA.full_join(q, mesh=mesh)
    assert (engA.stats.shred_builds, engA.stats.plan_misses) == \
        (st1.shred_builds, st1.plan_misses), engA.stats
    e2e["A"] = {"join_sizes": list(plan.join_sizes), "cap": plan.cap,
                "acap": plan.acap, "counts": counts, "z": zA,
                "first_calls_s": cold_s}
    if on_card:
        peak = torch.cuda.max_memory_allocated(device)
        e2e["A"]["peak_device_bytes"] = int(peak)
        e2e["A"]["own_peak_device_bytes"] = int(peak - held)
        log(f"[memory] H.A: peak {peak / 2**30:.3f} GiB, "
            f"{(peak - held) / 2**30:.3f} GiB over what earlier phases held "
            f"(four shards' indexes, each with every child relation)")
        la = launches["H.A"]
        assert la["tree_probe"] == 4 * (1 + len(keysA)), la
        assert la["bsearch_probe"] > 0 and la["fused_draw"] == 0, la
    log(f"[H.A] {plan.num_shards} shards of {plan.stacked.valid} titles, "
        f"join sizes {plan.join_sizes} (sum {plan.join_size}), route "
        f"{plan.route}, GET {plan.rep}, cap {plan.cap} a shard, acap "
        f"{plan.acap}: full_join(mesh=) equals the single-device join in "
        f"order; {len(counts)} sharded draws are rows of the join at their "
        f"positions, counts {counts} z {zA:+.2f} against E[k] {mean:.1f}; "
        f"warm calls build nothing; first calls (the stacked build "
        f"included) {cold_s:.2f} s")

    # -- H.F: deltas through apply_delta on the warm sharded plan -------------
    pol = engA.kernel_policy
    rng = np.random.default_rng(args.seed + 29)
    title = {c: v.cpu().numpy()
             for c, v in engA.db.relations["Title"].columns.items()}
    n_t = title["t"].shape[0]
    per = -(-n_t // 4)
    k = max(1, int(0.005 * (n_t - 3 * per)))
    last = rng.choice(np.arange(3 * per, n_t), k, replace=False)
    reprice = {"Title": {"delete": last, "insert": {
        "t": title["t"][last], "kind": title["kind"][last],
        "p": rng.beta(2, 10, k)}}}
    cast_churn = churn_spec(configs["A"][0], "Cast", 0.005, rng)
    e2e["F"] = {}
    for label, spec, want in (("H.F Cast churn", cast_churn, (0, 4)),
                              ("H.F last block", reprice, (3, 1))):
        delta = DeltaBatch.of(**spec)
        before = engA.stats.snapshot()
        t0 = time.perf_counter()
        smp = main_path(label, lambda: (engA.apply_delta(delta),
                                        engA.sample(q, keysA[0],
                                                    mesh=mesh))[1])
        wall = time.perf_counter() - t0
        after = engA.stats
        got = (after.shards_reused - before.shards_reused,
               after.shards_rebuilt - before.shards_rebuilt)
        assert got == want, (label, got)
        assert after.shred_builds == before.shred_builds, after
        assert engA.compile_sharded(q, mesh) is plan
        fresh, _ = build_stacked(engA.db, q, 4, rep=plan.stacked.shreds[0].rep,
                                 policy=pol, devices=[device] * 4)
        assert fresh.join_sizes == plan.join_sizes
        assert fresh.valid == plan.stacked.valid
        n_arr = sum(assert_same_shred(a, b, (label, s)) for s, (a, b) in
                    enumerate(zip(plan.stacked.shreds, fresh.shreds)))
        del fresh
        fullA = engA.full_join(q)
        check_sample(smp, fullA, label)
        e2e["F"][label] = {"delta_rows": delta.size(), "reused": got[0],
                           "rebuilt": got[1], "apply_and_draw_s": wall}
        log(f"[{label}] delta of {delta.size()} rows: apply_delta on the "
            f"sharded plan reused {got[0]} shards and rebuilt {got[1]} "
            f"(as predicted); its 4 shards equal a fresh build_stacked in "
            f"all {n_arr} arrays; a draw after it is rows of the new join; "
            f"{wall * 1e3:.1f} ms for apply_delta and the draw")
    del fullA

    # -- H.B: the fused draw a shard, batches, the batcher, the CLI -----------
    tabB = make_tables(args.seed + 1, args.serving_title_rows)
    dbB = Database.from_columns(tabB, device=device)
    engB = engine(dbB)
    planB = engB.compile(q)
    fullB = engB.full_join(q)
    keysB = [threefry.key(22_000 + s) for s in range(8)]
    smps = main_path("H.B", lambda: [engB.sample(q, k, mesh=mesh)
                                     for k in keysB])
    planS = engB.compile_sharded(q, mesh)
    assert planS.route == "fused" and planS.num_shards == 4, planS.route
    counts = [check_sample(smp, fullB, "H.B") for smp in smps]
    if on_card:
        assert launches["H.B"]["fused_draw"] == 4 * len(keysB)
    part = partition_root(semijoin_filter(dbB, q), q, 4)
    shard_engines = [engine(sdb) for sdb in part.shards]
    for k, smp in zip(keysB, smps):
        shards, total = planS.sample_step(k)
        assert int(total) == int(smp.count)
        for s, (got, eng) in enumerate(zip(shards, shard_engines)):
            want = eng.sample(q, threefry.fold_in(k, s), cap=planS.cap,
                              acap=planS.acap)
            assert_same_sample(got, want, ("H.B shard", s))
    del shard_engines, smps
    keys32 = threefry.keys(args.seed + 30, 32)
    batch = main_path("H.B batch", lambda: engB.sample_batch(q, keys32,
                                                             mesh=mesh))
    for b in range(32):
        assert_same_sample(lane(batch, b), engB.sample(q, keys32[b],
                                                       mesh=mesh),
                           ("H.B batch", b))
    if on_card:
        assert launches["H.B batch"]["fused_draw_batch"] == 4
    del batch
    log(f"[H.B] {planS.num_shards} shards (join sizes {planS.join_sizes}), "
        f"route {planS.route}: {len(keysB)} sharded draws are rows of the "
        f"join (counts {counts}), and each shard's draw equals one engine's "
        f"over that shard's database under fold_in(key, s) bit for bit; "
        f"sample_batch of 32 keys equals 32 sharded draws lane by lane")

    title_q = JoinQuery((Atom.of("Title", "t", "kind", "p"),), prob_var="p")
    title_cast = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                            Atom.of("Cast", "t", "person")), prob_var="p")
    shapes = (title_q, title_cast, q)
    n = args.serve_requests

    def stream():
        churn = np.random.default_rng(args.seed + 21)
        return serve_stream(shapes, n, 4,
                            lambda: churn_spec(tabB, "Cast", 0.005, churn),
                            5000)

    engS = engine(Database.from_columns(tabB, device=device))
    for sh in shapes:  # warm-up: one stack and one plan a shape
        engS.sample(sh, threefry.key(0), mesh=mesh)
    reqs = stream()
    t0 = time.perf_counter()
    main_path("H.B batcher", lambda: serve_join_samples(
        engS, reqs, mesh=mesh, max_batch=32, max_wait_ms=2.0))
    draws = served_draws(reqs)
    wall = time.perf_counter() - t0
    e2e["batcher_B"] = dict(draws=len(draws), wall_ms=wall * 1e3,
                            draws_per_s=len(draws) / wall)
    engR = engine(Database.from_columns(tabB, device=device))
    for r in reqs:
        if isinstance(r, UpdateRequest):
            engR.apply_delta(r.delta)
            continue
        want = engR.sample(r.query, threefry.key(r.seed), mesh=mesh)
        assert r.db_version == engR.db.version, (r.seed, r.db_version)
        assert (r.count, r.overflow) == (int(want.count),
                                         bool(want.overflow)), r.seed
    st = engS.stats
    log(f"[H.B batcher] MicroBatcher(mesh=) over phase G's stream ({n} "
        f"draws, 3 shapes, 4 Cast churns): {len(draws)} draws in "
        f"{wall * 1e3:.1f} ms ({len(draws) / wall:.1f} draws/s), each equal "
        f"to the sharded single draw at its version; shards reused "
        f"{st.shards_reused}, rebuilt {st.shards_rebuilt} ({st})")
    if on_card:
        assert launches["H.B batcher"]["fused_draw_batch"] > 0
    del engS, engR
    t0 = time.perf_counter()
    main_path("H.cli", lambda: serve.main(
        ["--mode", "join", "--devices", "4", "--device", str(device)],
        kernel_policy=kernel_policy))
    log(f"[H.cli] serve.main --mode join --devices 4: "
        f"{time.perf_counter() - t0:.1f} s, its checks held")

    # -- times ------------------------------------------------------------------
    # CUDA events around warm calls (each ends in a host read of the
    # count), sharded beside single-device, at A and B.
    t = {}
    keyT = threefry.key(7)
    for label, eng, reps, nb in (("A", engA, 3, 4), ("B", engB, args.reps,
                                                     32)):
        kb = threefry.keys(args.seed + 31, nb)
        t[label] = {
            "sample_sharded_ms": timed(
                lambda: int(eng.sample(q, keyT, mesh=mesh).count), reps,
                device),
            "sample_single_ms": timed(
                lambda: int(eng.sample(q, keyT).count), reps, device),
            f"batch{nb}_sharded_ms": timed(
                lambda: eng.sample_batch(q, kb, mesh=mesh).count.tolist(),
                reps, device),
            f"batch{nb}_single_ms": timed(
                lambda: eng.sample_batch(q, kb).count.tolist(), reps,
                device)}
        log(f"[time] H.{label} ({smi}): sample on 4 shards "
            f"{t[label]['sample_sharded_ms']:.3f} ms, single-device "
            f"{t[label]['sample_single_ms']:.3f} ms; sample_batch of {nb} on "
            f"4 shards {t[label][f'batch{nb}_sharded_ms']:.3f} ms, "
            f"single-device {t[label][f'batch{nb}_single_ms']:.3f} ms")
    if on_card and args.profile:
        kb = threefry.keys(args.seed + 31, 32)
        t["profile"] = {
            label: profile_window(fn, label, wall_ms(fn, device))
            for label, fn in (
                ("H.B sample on 4 shards",
                 lambda: int(engB.sample(q, keyT, mesh=mesh).count)),
                ("H.B sample_batch of 32 on 4 shards",
                 lambda: engB.sample_batch(q, kb,
                                           mesh=mesh).count.tolist()))}
    t["full_join_A_sharded_ms"] = timed(
        lambda: engA.full_join(q, mesh=mesh), 3, device)
    t["full_join_A_single_ms"] = timed(lambda: engA.full_join(q), 3, device)
    log(f"[time] H.A ({smi}): full_join on 4 shards "
        f"{t['full_join_A_sharded_ms']:.3f} ms, single-device "
        f"{t['full_join_A_single_ms']:.3f} ms")
    e2e["times"] = t
    return launches, e2e


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
    from repro_torch.kernels import csr_walk as cw_mod
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import geo_gaps as geo_mod
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import prefix_sum as ps_mod
    from repro_torch.kernels import threefry
    from repro_torch.kernels import tree_probe as tp_mod

    on_card = device.type == "cuda"
    kernels = {"tree_probe": tp_mod.tree_probe,
               "bsearch_probe": bp_mod.bsearch_probe,
               "fused_draw": fd_mod.fused_draw,
               "fused_sample": fd_mod.fused_sample,
               "fused_draw_batch": fd_mod.fused_draw_batch,
               "fused_sample_batch": fd_mod.fused_sample_batch,
               "tree_probe_paged": tp_mod.tree_probe_paged,
               "tree_probe_paged_dma": tp_mod.tree_probe_paged_dma,
               "tree_probe_paged_pages": tp_mod.tree_probe_paged_pages,
               "prefix_sum": ps_mod.prefix_sum_tiles,
               "prefix_sum_f32": ps_mod.prefix_sum_tiles.float32,
               "prefix_sum_f64": ps_mod.prefix_sum_tiles.float64,
               "geo_gaps": geo_mod.geo_gaps_tiles,
               "threefry_uniforms": threefry.uniforms,
               "flash_decode": dec_mod.flash_decode,
               "flash_prefill": pre_mod.flash_prefill,
               "csr_walk": cw_mod.csr_walk,
               "csr_walk_cached": cw_mod.csr_walk_cached}
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
            for entry, line in ptxas_lines(text):
                log(f"[build] {name}: {entry}: {line}")
        frames = [line for _, line in ptxas_lines(
            reports.get("tree_get") or build.ptxas_report("tree_get"))
            if "stack frame" in line]
        log(f"[build] tree_get: {len(frames)} instances; stack frames and "
            f"spills: {sorted(set(frames))}")
        # the draw's instances keep rows and locals in registers
        frames = [line for entry, line in ptxas_lines(
            reports.get("fused_draw") or build.ptxas_report("fused_draw"))
            if "fused_draw_kernel" in entry and "stack frame" in line]
        log(f"[build] fused_draw: {len(frames)} instances; stack frames and "
            f"spills: {sorted(set(frames))}")
        assert frames and all(line == "0 bytes stack frame, 0 bytes spill "
                              "stores, 0 bytes spill loads"
                              for line in frames), frames
        # the float scans' one launch and the caching walk: no frame either
        for name, kernel in (("scan", "sc_fixed_kernel"),
                             ("csr_walk", "csr_walk_cached_kernel")):
            frames = [line for entry, line in ptxas_lines(
                reports.get(name) or build.ptxas_report(name))
                if kernel in entry and "stack frame" in line]
            log(f"[build] {name}: {len(frames)} {kernel} instances; stack "
                f"frames and spills: {sorted(set(frames))}")
            assert frames and all(line == "0 bytes stack frame, 0 bytes "
                                  "spill stores, 0 bytes spill loads"
                                  for line in frames), (kernel, frames)
        # the bf16 attention kernels' tensor-core instructions in the SASS
        for name, op in (("flash_prefill_tc", "HGMMA"), ("flash_decode", "HMMA")):
            log(f"[build] {name}: {sass_count(build, name, op)}")

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
    layA = packA.layout
    nA = planA.join_size
    log(f"[A] arena {layA.size} int32: root prefix {layA.root_len}, "
        + ", ".join(f"edge {layA.names[e.parent]} -> {layA.names[e.slot]} "
                    f"cumw_excl {e.n_child + 1}" for e in layA.edges)
        + f"; pages {[e - s for s, e in layA.page_bounds()]}")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    posA = torch.arange(nA, dtype=torch.int32, device=device)
    smpA = engA.sample(q, threefry.key(999))
    tileA = tp_mod.THREADS * tp_mod.items_for(layA.num_slots)
    probesA = {
        "all positions": posA,
        "shuffled": posA[torch.randperm(nA, generator=gen, device=device)],
        "per-node sample": smpA.positions[:int(smpA.count)].to(torch.int32),
        "n = 1": posA[nA // 2:nA // 2 + 1],
        "ragged last tile": posA[:3 * tileA + 37]}
    del smpA
    if on_card:
        cfgA = tp_mod.tree_get_config(layA)
        log(f"[build] tree_get at A: {cfgA}; "
            f"{min(cfgA['blocks_per_sm'] * cfgA['sms'], -(-nA // tileA))} "
            f"blocks for A's join ({-(-nA // tileA)} tiles of {tileA})")
    errs["tree_probe"] = 0.0
    staged_A = {}
    for name, pos in probesA.items():
        got = tp_mod.tree_probe(packA.arena, pos, layA)
        want = tp_mod.tree_probe_plain(packA.arena, pos, layA)
        err = max_abs_err(got, want)
        stats = {}
        model = torch.stack(tp_mod.tree_walk_tiled(packA.arena, pos, layA,
                                                   stats=stats))
        assert torch.equal(model, want), name
        staged_A[name] = stats
        errs["tree_probe"] = max(errs["tree_probe"], err)
        log(f"[check] tree_probe (tree_get.cu) on A, {name} ({pos.numel()} "
            f"probes): kernel vs plain max_abs_err {err}; the plain model "
            f"of its tiles equal; of {stats['tiles']} tiles, staged by "
            "level: " + ", ".join(f"{k} {v}" for k, v in stats.items()
                                  if k != "tiles"))
        del got, want, model
    # bsearch_probe over A's root prefix as the main path passes it (the
    # arena's int32 view): sorted and shuffled queries, the queries of one
    # per-node draw through the per-node GET (EXPRACE's seg and rO
    # searches, then the GET's root locate), one query, a ragged last tile,
    # all-equal queries and queries past pref[-1]. Bit for bit against the
    # plain version, and the tiles that staged or fell back against the
    # plain model's (bsearch_probe_tiled) on the same input.
    prefA = planA.shred.root_pref32
    qA = torch.sort(torch.randint(0, nA + 1, (planA.arrival_capacity(),),
                                  generator=gen, device=device,
                                  dtype=torch.int32)).values
    qA_shuffled = qA[torch.randperm(qA.numel(), generator=gen, device=device)]
    drawn = []

    def record(pref, qq):
        drawn.append((pref, qq.clone()))
        return bp_mod.bsearch_probe(pref, qq)

    ops_mod.bsearch_probe = record
    try:
        planA.sample(threefry.key(999), rep="usr")
    finally:
        ops_mod.bsearch_probe = bp_mod.bsearch_probe
    assert len(drawn) == 3, len(drawn)
    topA = int(prefA[-1])
    tile_bs = bp_mod.THREADS * bp_mod.ITEMS
    probes_bs = {"sorted": (prefA, qA), "shuffled": (prefA, qA_shuffled)}
    probes_bs.update((f"per-node draw, {k}", pq) for k, pq in zip(
        ("seg", "rO", "root locate"), drawn))
    probes_bs.update({
        "n = 1": (prefA, qA[qA.numel() // 2:qA.numel() // 2 + 1]),
        "ragged last tile": (prefA, qA[:3 * tile_bs + 37]),
        "all equal": (prefA, torch.full((5000,), topA // 3,
                                        dtype=torch.int32, device=device)),
        "past pref[-1]": (prefA, torch.arange(topA - 5, topA + 5000,
                                              dtype=torch.int32,
                                              device=device))})
    del drawn
    if on_card:
        log(f"[build] bsearch_probe: {bp_mod.bsearch_probe_config()}")
    errs["bsearch_probe"] = 0.0
    tiles_bs = {}
    for name, (pref, qq) in probes_bs.items():
        stats, model_stats = {}, {}
        got = bp_mod.bsearch_probe(pref, qq, stats=stats)
        want = bp_mod.bsearch_probe_plain(pref, qq)
        model = bp_mod.bsearch_probe_tiled(pref, qq, stats=model_stats)
        err = max_abs_err(got, want)
        assert torch.equal(model, want), name
        assert stats == model_stats, (name, stats, model_stats)
        errs["bsearch_probe"] = max(errs["bsearch_probe"], err)
        tiles_bs[name] = stats
        log(f"[check] bsearch_probe on A, {name} ({qq.numel()} queries into "
            f"{pref.numel()} words): kernel vs plain max_abs_err {err}; "
            f"tiles staged / fell back: kernel {stats['staged']} / "
            f"{stats['fallback']}, plain model {model_stats['staged']} / "
            f"{model_stats['fallback']} of {stats['tiles']}")
        del got, want, model
    del probes_bs
    packB = planB.shred.packed
    capB, acapB = planB.default_capacity(), planB.arrival_capacity()
    keyB = threefry.key(args.seed)
    kw = dict(layout=packB.layout, method="exprace", cap=capB, acap=acapB)
    # Each draw of B and C is held against the plain version after its
    # phase's main-path run, with the configuration's parameters and, off
    # the main path, the same kernel on probabilities at both extremes (the
    # complement inversion, p = 0 and p = 1) and flat PTBERN (n = the join,
    # within draw_limit).
    rng = np.random.default_rng(args.seed)

    def variants(plan, eng):
        p_mix = torch.as_tensor(rng.choice(
            [0.0, 0.02, 0.3, 0.5, 0.7, 0.98, 1.0], plan.w.numel())).to(device)
        cap = plan.default_capacity()
        return (("main", plan.draw_params,
                 dict(method="exprace", cap=cap,
                      acap=plan.arrival_capacity())),
                ("extreme-p mix",
                 sampling.fused_draw_params(plan.w, p_mix, plan.prefE),
                 dict(method="exprace",
                      cap=eng.policy.sample_capacity(plan.w, p_mix),
                      acap=eng.policy.arrival_capacity(plan.w, p_mix))),
                ("flat PTBERN", plan.draw_params,
                 dict(method="ptbern_flat", cap=cap, n=plan.join_size)))

    variantsB = variants(planB, engB)
    grids = {}
    if on_card:
        for label, walk, plan in (("B", True, planB), ("C", False, planC)):
            per_sm, sms, blocks, _ = fd_mod.grid(
                walk, plan.arrival_capacity(), plan.default_capacity(),
                plan.w.numel(), layout=plan.shred.packed.layout)
            grids[label] = {"blocks_per_sm": per_sm, "sms": sms,
                            "blocks": blocks}
            log(f"[build] {'fused_draw' if walk else 'fused_sample'} "
                f"cooperative grid at {label}: occupancy {per_sm} blocks of "
                f"{fd_mod.THREADS} threads a multiprocessor x {sms} = "
                f"{per_sm * sms}; {blocks} blocks launched (acap "
                f"{plan.arrival_capacity()}, cap {plan.default_capacity()})")
    packC = planC.shred.packed
    pvC = PagedArena.from_packed(packC)
    nC, capC, acapC = planC.join_size, planC.default_capacity(), \
        planC.arrival_capacity()
    keyC = threefry.key(args.seed + 2)
    variantsC = variants(planC, engC)
    # The paged GET's three forms (one launch over the buffer, one over
    # the stacked pages, one launch per page) over every position of C and
    # one draw's positions, sentinels clamped as draw_paged clamps them.
    kwC = dict(method="exprace", cap=capC, acap=acapC)
    posC = torch.arange(nC, dtype=torch.int32, device=device)
    posS = torch.clamp(fd_mod.fused_sample(keyC, planC.draw_params, **kwC)[0],
                       max=nC - 1)
    paged_forms = (("tree_probe_paged", None), ("tree_probe_paged_dma", True),
                   ("tree_probe_paged_pages", False))

    def check_paged(pv, label):
        for name, pos in (("all positions", posC),
                          ("one draw's positions", posS)):
            want = tp_mod.tree_probe_plain(pv.buffer, pos, pv.layout)
            for kname, dma in paged_forms:
                err = max_abs_err(tp_mod.tree_probe_paged(pv, pos, dma=dma),
                                  want)
                errs[kname] = max(errs.get(kname, 0.0), err)
                log(f"[check] {kname} (dma={dma}) at {label}, {name} "
                    f"({pos.numel()} probes): vs plain max_abs_err {err}")

    check_paged(pvC, "C")
    u_dev = threefry.uniforms(keyB, acapB, 0, device)
    u_plain = threefry.uniforms_plain(keyB, acapB, 0, device)
    errs["threefry_uniforms"] = max_abs_err(u_dev, u_plain)
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
        assert launchesA["tree_probe"] == 1 + args.keys  # one a call
        assert launchesA["bsearch_probe"] > 0 and launchesA["fused_draw"] == 0
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
    keysB = [threefry.key(2000 + s) for s in range(args.draws)]
    smpsB = [engB.sample(q, key) for key in keysB]
    counts = [check_sample(smp, fullB, "B") for smp in smpsB]
    launchesB = {k: fn.launches for k, fn in kernels.items()}
    log(f"[B] launches {launchesB}")
    if on_card:
        assert launchesB["fused_draw"] == args.draws
        assert launchesB["tree_probe"] == 1
    meanB = planB.expected_k()
    sdB = float(estimate.sample_std(planB.w, planB.p))
    zB = (float(np.mean(counts)) - meanB) / (sdB / math.sqrt(len(counts)))
    log(f"[B] {len(counts)} draws: mean count {np.mean(counts):.1f} vs "
        f"E[k] {meanB:.1f}, z {zB:+.2f}")
    assert abs(zB) < Z_LIMIT
    errs["fused_draw"] = errs["fused_sample"] = 0.0
    check_draws("B", fd_mod, ps_mod, packB, variantsB, keysB, smpsB, errs)
    del smpsB
    check_join(fullB, tabB, "B")
    assert (engB.stats.shred_builds, engB.stats.plan_misses) == (1, 1), engB.stats

    # -- 5b. config C: the main path, paged draw ----------------------------
    for fn in kernels.values():
        fn.launches = 0
    fullC = engC.full_join(q)
    keysC = [threefry.key(3000 + s) for s in range(args.draws)]
    smpsC = [engC.sample(q, key) for key in keysC]
    counts = [check_sample(smp, fullC, "C") for smp in smpsC]
    launchesC = {k: fn.launches for k, fn in kernels.items()}
    log(f"[C] launches {launchesC}")
    if on_card:
        assert launchesC["fused_sample"] == args.draws
        assert launchesC["tree_probe_paged"] == args.draws  # one a draw
        assert launchesC["tree_probe_paged_dma"] == 0
        assert launchesC["tree_probe_paged_pages"] == 0
        assert launchesC["fused_draw"] == 0 and launchesC["tree_probe"] == 1
    meanC = planC.expected_k()
    sdC = float(estimate.sample_std(planC.w, planC.p))
    zC = (float(np.mean(counts)) - meanC) / (sdC / math.sqrt(len(counts)))
    log(f"[C] {len(counts)} draws: mean count {np.mean(counts):.1f} vs "
        f"E[k] {meanC:.1f}, z {zC:+.2f}")
    assert abs(zC) < Z_LIMIT
    check_draws("C", fd_mod, ps_mod, packC, variantsC, keysC, smpsC, errs)
    del smpsC
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
        assert launchesR["tree_probe_paged"] == 1 + len(keysR)
        assert launchesR["tree_probe_paged_dma"] == 0
        assert launchesR["tree_probe_paged_pages"] == 0
    # the three forms again over the index paged at build
    check_paged(planR.shred.paged, "C, arena_limit=draw_limit")
    for kname, _ in paged_forms:
        assert errs[kname] == 0.0, kname

    # -- 5d. phase E: batched draws, uniform samplers, facades, repeats -------
    launchesE, rowsE, callE, e2eE, windowsE, phasesE = run_batched(
        args, device, q, configs, (fullA, fullB, fullC), kernels, errs,
        bp_mod.steps_for)

    # -- 6. times --------------------------------------------------------------
    # Each kernel's wrapper by CUDA events (``reps`` warm calls; at least
    # 50 for the kernels of the last redesign, whose calls are short); the
    # device time of each (``call``) is taken after every timing of the
    # run, so that no profiler session precedes a timing.
    steps = bp_mod.steps_for
    reps = args.reps
    reps_short = max(reps, 50)
    rows = []
    call = {}
    call["tree_probe"] = lambda: tp_mod.tree_probe(packA.arena, posA,
                                                   packA.layout)
    ms = timed(call["tree_probe"], reps, device)
    plain_ms = timed(lambda: tp_mod.tree_probe_plain(packA.arena, posA,
                                                     packA.layout), 1, device)
    b_ms, b_by = bound(4 * (packA.layout.size + nA * (1 + packA.layout.num_slots)),
                       nA * walk_ops(packA.layout, steps))
    rows.append(("tree_probe", "src/repro/kernels/tree_probe.py:111",
                 ms, plain_ms, b_ms, b_by, None))
    call["bsearch_probe"] = lambda: bp_mod.bsearch_probe(prefA, qA)
    ms = timed(call["bsearch_probe"], reps_short, device)
    plain_ms = timed(lambda: bp_mod.bsearch_probe_plain(prefA, qA), 1, device)
    lib_ms = timed(lambda: torch.searchsorted(prefA, qA, right=True) - 1,
                   reps_short, device)
    b_ms, b_by = bound(4 * (prefA.numel() + 2 * qA.numel()),
                       qA.numel() * 6 * steps(prefA.numel()))
    rows.append(("bsearch_probe", "src/repro/kernels/bsearch_probe.py:43",
                 ms, plain_ms, b_ms, b_by, lib_ms))
    shuffled_ms = timed(lambda: bp_mod.bsearch_probe(prefA, qA_shuffled),
                        reps_short, device)
    log(f"[time] bsearch_probe on A's {qA.numel()} queries shuffled: "
        f"{shuffled_ms:.4f} ms (sorted {ms:.4f})")
    call["fused_draw"] = lambda: fd_mod.fused_draw(
        packB.arena, keyB, planB.draw_params, **kw)
    ms = timed(call["fused_draw"], reps, device)
    plain_ms = timed(lambda: fd_mod.fused_draw_plain(
        packB.arena, keyB, planB.draw_params, **kw), 1, device)
    b_ms, b_by = draw_bound(planB, packB.layout, steps)
    rows.append(("fused_draw", "src/repro/kernels/fused_draw.py:212",
                 ms, plain_ms, b_ms, b_by, None))
    # fused_sample at C's main-path shapes: the draw without the walk.
    call["fused_sample"] = lambda: fd_mod.fused_sample(
        keyC, planC.draw_params, **kwC)
    ms = timed(call["fused_sample"], reps, device)
    plain_ms = timed(lambda: fd_mod.fused_sample_plain(
        keyC, planC.draw_params, **kwC), 1, device)
    b_ms, b_by = draw_bound(planC, None, steps)
    rows.append(("fused_sample", "src/repro/kernels/fused_draw.py:261",
                 ms, plain_ms, b_ms, b_by, None))
    # The paged GET's three forms at the paged draw's shape: one draw's
    # positions. The plain version of the default is the walk of the
    # buffer; of the others, their page steps.
    lay = packC.layout
    b_ms, b_by = bound(4 * (lay.size + capC * (1 + lay.num_slots)),
                       capC * walk_ops(lay, steps))
    for (name, dma), replaces in zip(paged_forms, (
            "src/repro/kernels/tree_probe.py:195",
            "src/repro/kernels/tree_probe.py:274",
            "src/repro/kernels/tree_probe.py:195")):
        call[name] = (lambda d: lambda: tp_mod.tree_probe_paged(
            pvC, posS, dma=d))(dma)
        ms = timed(call[name], reps, device)
        plain_ms = timed(
            (lambda: tp_mod.tree_probe_plain(pvC.buffer, posS, lay))
            if dma is None else (lambda: tp_mod.tree_probe_paged_plain(
                pvC, posS, dma=dma)), 1, device)
        rows.append((name, replaces, ms, plain_ms, b_ms, b_by, None))
    # The paged GET's forms and the walk of the whole arena over the whole
    # join of C (the paged GET's shape), side by side.
    get_ms = {
        "per-page": timed(lambda: tp_mod.tree_probe_paged(pvC, posC,
                                                          dma=False),
                          reps, device),
        "one-launch buffer": timed(lambda: tp_mod.tree_probe_paged(pvC, posC),
                                   reps, device),
        "one-launch stacked": timed(lambda: tp_mod.tree_probe_paged(
            pvC, posC, dma=True), reps, device),
        "tree_probe": timed(lambda: tp_mod.tree_probe(packC.arena, posC, lay),
                            reps, device)}
    log(f"[time] walks of all {nC} positions of C (ms): {get_ms}")
    yardstick = {}
    if on_card and args.profile:
        # A yardstick for the reads no tile can stage: the last edge's
        # child_start and child_w at A's full join, indexed by its parent's
        # rows (in random order), as two library gathers.
        e = layA.edges[-1]
        prow = tp_mod.tree_probe(packA.arena, posA, layA)[e.parent]
        gather_ms = timed(lambda: (packA.arena[e.cs_off + prow],
                                   packA.arena[e.cw_off + prow]), reps, device)
        yardstick["A last edge parent-row gathers"] = gather_ms
        log(f"[profile] A's edge {layA.names[e.parent]} -> "
            f"{layA.names[e.slot]}: child_start and child_w gathered at "
            f"{nA} parent rows by torch indexing: {gather_ms:.4f} ms")
        del prow

    e2e = {
        "full_join_A_ms": wall_ms(lambda: engA.full_join(q), device),
        "sample_A_ms": wall_ms(lambda: engA.sample(q, threefry.key(7)), device),
        "sample_B_ms": wall_ms(lambda: engB.sample(q, threefry.key(7)), device),
        "sample_C_ms": wall_ms(lambda: engC.sample(q, threefry.key(7)), device),
    }
    for k, v in e2e.items():
        log(f"[time] warm {k}: {v:.3f}")
    if on_card:
        e2e["peak_device_bytes_A_to_C"] = int(
            torch.cuda.max_memory_allocated(device))
    e2e.update(e2eE)
    rows += rowsE
    call.update(callE)
    e2e["walks_C_ms"] = get_ms
    e2e["tree_get_staged_A"] = staged_A
    e2e["tree_get_yardstick"] = yardstick

    # -- 7. phase D: the kernel-ops entry point, after A-C's timings so that
    # its multi-GiB attention inputs do not change the conditions of theirs
    rowsD, errsD, launchesD, sizesD = run_ops(args, device, kernels,
                                              planA.join_size)
    # -- 7b. device time: each row's call, then (--profile) the warm engine
    # calls by kernel, after every timing of the run
    dev_ms = sizesD.pop("device_ms")
    if on_card:
        for name, fn in call.items():
            dev_ms[name] = device_ms(fn)
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
        for label, (fn, wall) in windowsE.items():
            e2e["profile"][label] = profile_window(fn, label, wall)
        # The draw kernel's own phases (its global clock after each grid
        # barrier), the mean of 10 launches after one.
        (arenaE, keysE, paramsE, kwE), (_, keysEC, paramsEC, kwEC) = phasesE
        for label, arena, key, params, kwx in (
                ("fused_draw at B", packB.arena, keyB, planB.draw_params, kw),
                ("fused_sample at C", None, keyC, planC.draw_params,
                 dict(kwC, layout=None)),
                (f"fused_draw_batch of {len(keysE)} at B", arenaE, None,
                 paramsE, dict(kwE, keys=keysE)),
                (f"fused_sample_batch of {len(keysEC)} at C", None, None,
                 paramsEC, dict(kwEC, keys=keysEC))):
            runs = [fd_mod.phase_ms(arena, key, params, **kwx)
                    for _ in range(11)][1:]
            mean = {k: sum(r[k] for r in runs) / len(runs) for k in runs[0]}
            e2e["profile"][f"phases {label}"] = mean
            log(f"[profile] {label} phases (ms, mean of {len(runs)}): "
                f"total {sum(mean.values()):.4f}; " + ", ".join(
                    f"{k} {v:.4f}" for k, v in mean.items()))
    errs["threefry_uniforms"] = max(errs["threefry_uniforms"],
                                    errsD.pop("threefry_uniforms"))
    errs.update(errsD)
    # -- 7c. phase F: updates on the card (it advances A-C's engines)
    launchesF, e2eF, rowsF = run_updates(args, device, q, configs, kernels,
                                         errs, dev_ms)
    rows += rowsF
    e2e["updates"] = e2eF
    # -- 7d. phase G: serving and the data plane, last
    launchesG, e2eG = run_serving(args, device, q, configs, kernels,
                                  kernel_policy)
    e2e["serving"] = e2eG
    # -- 7e. phase H: sharded sampling, last
    launchesH, e2eH = run_sharding(args, device, q, configs, kernels,
                                   kernel_policy)
    e2e["sharding"] = e2eH
    for k in kernels:
        launches[k] = (launchesA[k] + launchesB[k] + launchesC[k]
                       + launchesR[k] + launchesD[k]
                       + sum(lp[k] for lp in launchesE.values())
                       + sum(lp[k] for lp in launchesF.values())
                       + sum(lp[k] for lp in launchesG.values())
                       + sum(lp[k] for lp in launchesH.values()))

    # -- 8. the kernels' rows ---------------------------------------------------
    sources = {"fused_sample": "fused_draw.cu", "tree_probe": "tree_get.cu",
               "fused_draw_batch": "fused_draw.cu",
               "fused_sample_batch": "fused_draw.cu",
               "prefix_sum_f64": "scan.cu",
               "tree_probe_paged": "tree_get.cu",
               "tree_probe_paged_dma": "tree_get.cu",
               "tree_probe_paged_pages": "tree_probe_paged.cu",
               "csr_walk_cached": "csr_walk.cu"}
    rows = [r[:2] + (sources.get(r[0], f"{r[0]}.cu"),) + r[2:] for r in rows]
    table = []
    for name, replaces, source, ms, plain_ms, b_ms, b_by, lib_ms in rows + rowsD:
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        dms = (f"; device {dev_ms[name][0]:.4f} ms in "
               f"{dev_ms[name][1]:g} operations a call"
               if name in dev_ms else "")
        log(f"[time] {name}: {ms:.4f} ms (plain {plain_ms:.3f}, bound "
            f"{b_ms:.4f} by {b_by}"
            + (f", library {lib_ms:.4f}" if lib_ms is not None else "")
            + f"){dms}")
    for name in ("flash_decode_f32", "flash_prefill_f32", "flash_prefill_32k"):
        if name in dev_ms:
            log(f"[time] {name}: device {dev_ms[name][0]:.4f} ms in "
                f"{dev_ms[name][1]:g} operations a call")

    if on_card:
        e2e["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(device))
        log(f"[memory] peak device memory {e2e['peak_device_bytes'] / 2**30:.2f} "
            f"GiB ({e2e['peak_device_bytes_A_to_C'] / 2**30:.2f} GiB through "
            f"A-C)")
    return {"kernels": table, "end_to_end": e2e, "ops_sizes": sizesD,
            "draw_grids": grids, "device_ms": dev_ms,
            "bsearch_tiles_A": tiles_bs, "phase_e_launches": launchesE,
            "phase_f_launches": launchesF,
            "phase_g_launches": launchesG,
            "phase_h_launches": launchesH,
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
    ap.add_argument("--scan-n", type=int, default=IMDB_CAST,
                    help="elements of phase D's prefix sums (Cast's rows)")
    ap.add_argument("--decode-batch", type=int, default=16,
                    help="batch of phase D's llama3-405b decode")
    ap.add_argument("--decode-seq", type=int, default=32_768,
                    help="KV cache length of phase D's decode")
    ap.add_argument("--prefill-seq", type=int, default=4096,
                    help="sequence of phase D's llama3-405b prefill")
    ap.add_argument("--prefill-long-seq", type=int, default=32_768,
                    help="sequence of phase D's prefill_32k case")
    ap.add_argument("--serve-requests", type=int, default=256,
                    help="draws of phase G's serving stream at B")
    ap.add_argument("--corpus-docs", type=int, default=1_000_000,
                    help="documents of phase G's training corpus")
    ap.add_argument("--corpus-seq", type=int, default=1024,
                    help="tokens a document of phase G's corpus")
    ap.add_argument("--serving-profiles", action="store_true",
                    help=argparse.SUPPRESS)  # phase G's windows, a child
    ap.add_argument("--every-card", action="store_true",
                    help="only hold the batched draws on every visible card "
                         "against their plain versions")
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

    if args.serving_profiles:
        torch.cuda.set_device(0)
        print("PROFILES " + json.dumps(run_serving_profiles(
            args, torch.device("cuda", 0))))
        return 0
    if args.every_card:
        print("CARDS " + json.dumps(run_every_card(args)))
        return 0
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
