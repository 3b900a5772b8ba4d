#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's main path through its entry points at JOB scale: the
index build, the full join through the GET kernel (``tree_probe``, from
``csrc/tree_get.cu``), Poisson sampling through the per-node route
(``bsearch_probe`` + ``tree_probe``), through the one-launch ``fused_draw``
kernel, and through the paged draw (``fused_sample`` + ``tree_probe_paged``,
one launch of the GET kernel over the pages); then (phase D) the kernel-ops
entry point ``repro_torch.kernels.ops``: ``prefix_sum``,
``geo_positions_fused``, ``decode_attention`` and ``prefill_attention``
(the ``scan``, ``flash_decode``, ``flash_prefill`` and
``flash_prefill_tc`` kernels). It builds
every kernel from ``src/repro_torch/kernels/csrc/``, holds each against
its plain PyTorch version on the card (the GET kernel on A's sorted,
shuffled and sampled positions, one probe and a ragged last tile; the
bsearch kernel on A's sorted and shuffled queries, the searches of one
per-node draw, one query, a ragged tile, equal queries and queries past
the prefix, its staged tiles against its plain model's; the paged GET's
three forms at C; the int32 and GEO look-back at each tile size, across
its switch of tile, 100 calls of both in turn on one scratch and on a
second stream), checks the join against an independent numpy expansion
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
  D  ops               prefix sums over Cast's 36,244,344 weights (int32,
                       inclusive and exclusive; float32); GEO positions at
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
            raw = ps_mod.scan_order_f32(-torch.log1p(-u), fd_mod.THREADS,
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
          "float32 random": ops.prefix_sum(w_rand)}
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
        assert launches["prefix_sum"] == len(ps)
        assert launches["geo_gaps"] == launches["threefry_uniforms"] == GEO_KEYS
        assert launches["flash_decode"] == len(dec_cases)
        assert launches["flash_prefill"] == len(pre_cases) + 1
        assert all(launches[k] == 0 for k in kernels if k not in (
            "prefix_sum", "geo_gaps", "threefry_uniforms", "flash_decode",
            "flash_prefill"))

    # -- each kernel against its plain version ---------------------------------
    errs = {}
    want_i32 = ps_mod.prefix_sum_plain(w_i32)
    assert torch.equal(want_i32.long(), torch.cumsum(w_i32.long(), 0))
    want_f32 = ps_mod.prefix_sum_plain(w_f32)
    assert torch.equal(want_f32.double(), torch.cumsum(w_f32.double(), 0))
    want_rand = ps_mod.prefix_sum_plain(w_rand)
    want_ex = torch.cat([want_i32.new_zeros(1), want_i32[:-1]])
    errs["prefix_sum"] = max(
        max_abs_err(ps["int32"], want_i32),
        max_abs_err(ps["int32 exclusive"], want_ex),
        max_abs_err(ps["float32 integer-valued"], want_f32),
        max_abs_err(ps["float32 random"], want_rand))
    drift = max_abs_err(ps["float32 random"], torch.cumsum(w_rand.double(), 0))
    log(f"[check] prefix_sum: n {n}, int32 (sum {int(want_i32[-1])}) and "
        f"exclusive, float32 integer-valued (sum {int(want_f32[-1])}) and "
        f"random: kernel vs plain max_abs_err {errs['prefix_sum']} (random "
        f"float32 against a float64 cumsum: {drift:.4g})")
    assert errs["prefix_sum"] == 0.0
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
    for i in range(100):
        if i % 2:
            wrong_geo += (geo_mod.geo_gaps_tiles(u0, GEO_P) != first_geo).sum()
        else:
            wrong_ps += (ps_mod.prefix_sum_tiles(w_i32) != first).sum()
    assert int(wrong_ps) == 0 and int(wrong_geo) == 0
    assert torch.equal(first_geo, geo_mod.geo_gaps_plain(u0, GEO_P))
    side_note = "no second stream off the card"
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            side_ps = ps_mod.prefix_sum_tiles(w_i32)
            side_geo = geo_mod.geo_gaps_tiles(u0, GEO_P)
        torch.cuda.current_stream(device).wait_stream(side)
        assert torch.equal(side_ps, first) and torch.equal(side_geo, first_geo)
        side_note = (f"a second stream equal too ({len(ps_mod._SCRATCH)} "
                     "scratches, one a stream)")
        del side_ps, side_geo
    log(f"[check] prefix_sum and geo_gaps in turn, 100 calls back to back "
        f"on one scratch: {int(wrong_ps)} / {int(wrong_geo)} elements differ "
        f"from the first calls; {side_note}")
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
    log(f"[time] flash_prefill llama3-405b bf16 S={S32} causal (tensor "
        f"cores): {ms32:.4f} ms (bound {b32[0]:.4f} by {b32[1]}"
        + (f", library {lib32:.4f}" if lib32 is not None else "") + ")")
    # the float32 instances, on the CUDA cores
    qf, kf, vf, bf, _ = list(dec_cases.values())[2]
    f32_dec_ms = timed(lambda: ops.decode_attention(qf, kf, vf, bf), reps,
                       device)
    f32_pre_ms = timed(lambda: ops.prefill_attention(qs, ks, vs, causal=True),
                       reps, device)
    maskf = (bf == 0)[:, None, None, :]
    f32_dec_lib = library_timed(lambda: F.scaled_dot_product_attention(
        qf[:, :, None], kf, vf, attn_mask=maskf, enable_gqa=True), reps,
        device, "flash_decode float32")
    f32_pre_lib = library_timed(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True), reps, device,
        "flash_prefill float32")
    log(f"[time] flash_decode float32 (CUDA cores) B=2 H=8 KV=2 D=128 "
        f"S={Sf}: {f32_dec_ms:.4f} ms (library {f32_dec_lib}); "
        f"flash_prefill float32 (CUDA cores) smollm-135m B=2 S=1000 causal: "
        f"{f32_pre_ms:.4f} ms (library {f32_pre_lib})")
    sizes = {"scan_n": n, "geo_join": n_join, "geo_lanes": lanes,
             "decode": list(dec_cases), "prefill": list(pre_cases),
             "prefill_32k": {"S": S32, "ms": ms32, "library_ms": lib32,
                             "bound_ms": b32[0], "bound_by": b32[1]},
             "float32_ms": {"flash_decode": f32_dec_ms,
                            "flash_prefill": f32_pre_ms,
                            "flash_decode_library": f32_dec_lib,
                            "flash_prefill_library": f32_pre_lib}}
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
               "tree_probe_paged": tp_mod.tree_probe_paged,
               "tree_probe_paged_dma": tp_mod.tree_probe_paged_dma,
               "tree_probe_paged_pages": tp_mod.tree_probe_paged_pages,
               "prefix_sum": ps_mod.prefix_sum_tiles,
               "geo_gaps": geo_mod.geo_gaps_tiles,
               "threefry_uniforms": threefry.uniforms,
               "flash_decode": dec_mod.flash_decode,
               "flash_prefill": pre_mod.flash_prefill}
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
            per_sm, sms, blocks = fd_mod.grid(
                walk, plan.arrival_capacity(), plan.default_capacity(),
                plan.w.numel())
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
    call["fused_sample"] = lambda: fd_mod.fused_sample(
        keyC, planC.draw_params, **kwC)
    ms = timed(call["fused_sample"], reps, device)
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
        # The draw kernel's own phases (its global clock after each grid
        # barrier), the mean of 10 launches after one.
        for label, arena, key, params, kwx in (
                ("fused_draw at B", packB.arena, keyB, planB.draw_params, kw),
                ("fused_sample at C", None, keyC, planC.draw_params,
                 dict(kwC, layout=None))):
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
    for k in kernels:
        launches[k] = (launchesA[k] + launchesB[k] + launchesC[k]
                       + launchesR[k] + launchesD[k])

    # -- 8. the kernels' rows ---------------------------------------------------
    sources = {"fused_sample": "fused_draw.cu", "tree_probe": "tree_get.cu",
               "tree_probe_paged": "tree_get.cu",
               "tree_probe_paged_dma": "tree_get.cu",
               "tree_probe_paged_pages": "tree_probe_paged.cu"}
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

    if on_card:
        e2e["peak_device_bytes"] = int(torch.cuda.max_memory_allocated(device))
        log(f"[memory] peak device memory {e2e['peak_device_bytes'] / 2**30:.2f} "
            f"GiB ({e2e['peak_device_bytes_A_to_C'] / 2**30:.2f} GiB through "
            f"A-C)")
    return {"kernels": table, "end_to_end": e2e, "ops_sizes": sizesD,
            "draw_grids": grids, "device_ms": dev_ms,
            "bsearch_tiles_A": tiles_bs,
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
