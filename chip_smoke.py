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
of four entries on the card; then (phase I) LM serving: ``serve_batch``
at smollm-135m's published config in bf16, its prefill through
``flash_prefill`` and its decode steps through ``flash_decode``; then
(phase J) LM training: ``python -m repro_torch.launch.train --full`` and the
port's ``train_lm_joinsampled`` at smollm-135m's published widths on
Poisson-join-sampled batches, the attention's gradient through the
kernel's autograd wrapper, with a kill and a resume; then (phase K) data
parallelism over four entries on the card (``train`` with
``TrainConfig.devices``), int8 gradient compression with error feedback,
the GPipe forward over a stage axis and the dry run
(``launch.dryrun``); then (phase L) tile tuning: ``autotune --check`` on
the committed ``TUNE_TABLE.json``, a sweep of every kernel's candidate
tiles on this card into a scratch table, and every candidate instance of
the five tuned kernels and the float32 attention kernels (D 16 too)
against its plain version at ragged shapes, with the checked GET and bf16
prefill at every candidate; then (phase M) EpiQL and the seven
architectures that fit the card, each at its published config through
``serve_batch`` (its attention through ``flash_prefill`` and
``flash_decode``, the checked builds of both at each of its shapes), and
``serve --mode lm --full``; then (phase N) the reduced config of each of
the ten architectures (head dim 16, float32: the float32 attention
kernels' D 16 instances), ``serve --mode lm`` with its defaults and a
reduced ``train``. Phases A-K, M and N run the tiles the committed table
resolves for this card; each tuned kernel's ``tile`` in the kernels line
counts its main-path launches by instance. It builds
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

Each CUDA source's checked build (``kernels/build.py`` ``VARIANTS``: every
load and store of a launch held against the launch's operands) runs in
the phases that launch its kernel, on the same inputs, at the tile the
main path resolves, and its output is held against the plain version:
the GET at A's every position and the bsearch kernel at each of A's
cases (phase A), the per-page GET at C (phase C), the draw at each of
phase E's batches and the float64 scan at A's masses (E), the scans at
phase D's sizes (D), the walks at A's full join, one draw and the skewed
edge (F); each of the four newer builds also at ragged sizes (one
element, a tile less one and plus one, a view one element into its
allocation; the scans on streams of their own, whose scratch grows), and
each with one operand's range left out, which must count (the negative
control). Each run prints ``[check] <kernel>.out_of_bounds count=<n>``,
each phase asserts its counts 0, and the kernels line has a row per
checked build beside the row whose call it repeats.

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
                       32 and 64 keys, flat PTBERN) and at ``serve --mode
                       join``'s demo corpus, each launch again through the
                       checked build (``fused_draw.out_of_bounds``: no load
                       outside its operands); ``uniform_sample`` at A
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
  I  lm-serving        smollm-135m at its published config (30 layers,
                       d_model 576, H 9, KV 3, head dim 64, vocabulary
                       49,152, tied embeddings; 135 M float32 parameters
                       drawn from ``--seed``, bf16 compute; not cut):
                       ``serve_batch`` of 8 prompts of 128-1,024 tokens
                       (from ``--seed``), 32 greedy tokens each, with 30
                       ``flash_prefill`` launches a prefill, 30
                       ``flash_decode`` a step and no plain attention call;
                       each kernel at layers 0 and 29 against its plain
                       version on the model's own q, k, v (prefill and one
                       step); at float32 compute ``prefill`` and a
                       ``decode_step`` against ``forward``; the bf16
                       prefill's logits against the plain path's. Shrink
                       it with ``--lm-requests``, ``--lm-prompt-min``,
                       ``--lm-prompt-max`` and ``--lm-new``.
  J  lm-training       smollm-135m at its published widths (as I; remat
                       "full"), B 8 x S 2,048 (its context): 16,384 tokens
                       a step from ``train``'s own corpus
                       (``make_corpus_db(512, 16, 2,049)``) through
                       ``PoissonJoinSource`` (a window of 8 steps one
                       ``fused_draw_batch``), a ``corpus_delta`` (64 in, 8
                       out) at step 8. ``launch.train.main --full`` for 3
                       steps; every parameter's gradient through the kernel
                       route against the plain route's (``TRAIN_GRAD_TOL``);
                       the attention backward alone against autograd of the
                       plain version; the checked ``flash_prefill_tc`` build
                       at the training shapes (phase I checks its serving
                       shapes); run A of ``train_lm_joinsampled`` (24 steps,
                       launches counted: two ``flash_prefill`` a layer a
                       step, one ``fused_draw_batch`` a window, no plain
                       attention call), the loss falling; run B killed after
                       12 and resumed, each leg a process of its own, bit for
                       bit equal to A; the newest checkpoint corrupted and
                       the restart resuming from the one before. Its sizes
                       are constants (``TRAIN_BATCH`` and the rest), not
                       options.
  K  parallel          smollm-135m as J. K.dp: ``train`` over a ("data" 4,
                       "model" 1) mesh of four entries on the card, J's
                       batch split 2 an entry, 4 steps (launches: two
                       ``flash_prefill`` a layer an entry a step); one
                       step's gradients against the single entry's
                       (``DP_GRAD_TOL``); the same run by 4
                       ``dp_train_step``s, bit for bit ``train``'s,
                       replicas bit-equal after each, and
                       ``compressed_psum_grads`` over the entries' real
                       gradients with the error carried (the mean within
                       scale / 2, errors within scale / 2, the accumulated
                       sum within one step). K.pipe: ``pipeline_forward``
                       over 5 stages of 6 layers, 8 microbatches of 1 x
                       1,024, against ``reference_forward`` and the forward
                       pass (``PIPE_TOL``; (8 + 4) x 30 ``flash_prefill``
                       launches). K.dryrun: ``launch.dryrun --all`` on
                       ``meta`` (every cell, both meshes; each record's
                       collective bytes and dominant roofline term held
                       present) and ``--paper`` on the card. Its sizes are
                       constants.
  M  archs             EpiQL (the paper's Example 1.1) at 100,000 people,
                       5 days (the contact join 133 M tuples, a draw a
                       day; day 0 again against its plain version and
                       the CPU's; two days again per node); gemma3-1b,
                       zamba2-1.2b, whisper-small, olmoe-1b-7b, rwkv6-7b,
                       starcoder2-7b and llama-3.2-vision-11b at their
                       published configs (``configs/*``; 35.8 B float32
                       parameters in all, drawn from ``--seed``; bf16
                       compute; not cut): ``serve_batch`` of 4 prompts of
                       128-512 tokens, 16 greedy tokens each, every
                       route's calls a layer as ``ARCH_ROUTES`` and no
                       plain attention call; each kernel route's first
                       and last layer against its plain version and
                       through its checked build at the resolved tile;
                       the kernel path's
                       logits against the plain path's; at float32
                       ``prefill`` and a ``decode_step`` against
                       ``forward`` (``ARCH_F32_CHECK``); ``serve --mode lm
                       --full --arch gemma3_1b`` in a child process. Its
                       sizes are constants (``ARCH_*``).
  N  reduced           the ten architectures' reduced configs
                       (``configs.reduced``: head dim 16, float32, two
                       repeats of each block type; llama3-405b and
                       llama4-scout run on the card only here):
                       ``serve_batch`` of 2 prompts of 8-24 tokens, 8
                       greedy tokens each, every route's calls as
                       ``ARCH_ROUTES_N`` and no plain attention call; the
                       prefill's and every step's logits against the plain
                       path's, teacher-forced (``LM_PREFILL_TOL``); each
                       route's first call through the float32 checked
                       builds; ``serve --mode lm`` with its defaults in a
                       child process; ``launch.train`` on the reduced
                       smollm-135m, 3 steps, and its gradients against the
                       plain route's (``TRAIN_GRAD_TOL``). Its sizes are
                       constants (``REDUCED_*``).
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
                       widths (S = 1,000, ragged, float32 and bf16; the
                       float32 kernel's checked build there) and gemma3-1b
                       widths (D = 256, S = 2,048). bf16 attention runs the
                       tensor-core kernels, float32 the CUDA-core ones
                       (timed too).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero without one. ``--every-card``
instead holds the batched draws on each visible card in turn against their
plain versions (a machine with several cards) and prints ``CARDS {...}``. The last line is
``{"ok": true, "device": {...}}``; the line before it lists each kernel's
launches, agreement and times (the checked builds of phases M and N too,
with no main-path launches); the line before that is the card's name and
power limit as ``nvidia-smi`` reports them, after the ``ARCHS``,
``REDUCED``, ``TRAINING`` and ``PARALLEL`` summaries.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import os
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
    calls of ``fn`` under ``torch.profiler``, summed by name (a
    ``record_function`` range's span on the device is not one of them)."""
    return [e for e in profiled(fn, reps).key_averages()
            if is_device_work(e)]


def profiled(fn, reps: int):
    """``torch.profiler``'s trace (CPU and CUDA) of ``reps`` warm calls of
    ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return prof


def is_device_work(e) -> bool:
    """Whether a profiler event is work on the device: a kernel, memset or
    copy, not a user range's span there."""
    from torch.autograd import DeviceType

    return (e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.self_device_time_total > 0)


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


# each tuned kernel's launches by instance (its wrapper's ``tiles``) over
# every main-path window of the run (``launch_counts``): the kernels line's
# ``tile``
MAIN_TILES: dict = {}


def reset_counts(kernels) -> None:
    """The start of a main-path window: every kernel's ``launches`` at 0,
    every tuned kernel's ``tiles`` empty."""
    for f in kernels.values():
        f.launches = 0
        if hasattr(f, "tiles"):
            f.tiles.clear()


def window_tiles(kernels) -> dict:
    """The tuned kernels' launches by instance since ``reset_counts``."""
    return {k: dict(f.tiles) for k, f in kernels.items()
            if getattr(f, "tiles", None)}


def launch_counts(kernels) -> dict:
    """The end of a main-path window: each kernel's launches in it; its
    tuned kernels' launches by instance are added to ``MAIN_TILES``."""
    for k, tiles in window_tiles(kernels).items():
        into = MAIN_TILES.setdefault(k, {})
        for tile, n in tiles.items():
            into[tile] = into.get(tile, 0) + n
    return {k: f.launches for k, f in kernels.items()}


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


# The checked builds that phases A-F run (build.VARIANTS, one a source;
# phase L's GET and attention candidates and phases M's and N's attention
# builds report through their own lines): build -> its runs, each a dict
# of the kernel, the shape, the accesses outside the operands ("count"),
# the checked call's ms (the ranges set, the launch, the count read back),
# its output's error against the plain version ("err") and the main-path
# row whose shape and call it repeats ("row", or None).
CHECKED: dict = {}
CHECKED_SOURCES = {"fused_draw_checked": "fused_draw.cu",
                   "tree_get_checked": "tree_get.cu",
                   "bsearch_probe_checked": "bsearch_probe.cu",
                   "tree_probe_paged_checked": "tree_probe_paged.cu",
                   "scan_checked": "scan.cu",
                   "csr_walk_checked": "csr_walk.cu"}


def bounds_checked(build_name: str, kernel: str, label: str, fn, want=None,
                   row=None) -> dict:
    """One checked launch, ``fn()`` (an ``out_of_bounds`` wrapper; called
    twice when ``row`` names the main-path row it repeats, the second call
    timed, so that no library load counts). Logs ``[check]
    <kernel>.out_of_bounds count=<n>``, with the first records when n > 0,
    and the output against ``want`` (the plain version's; a tuple item by
    item, None items skipped); keeps the run in ``CHECKED``; returns the
    wrapper's result. The phase asserts the counts
    (``assert_in_bounds``)."""
    if row is not None:
        fn()
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    err = None
    if want is not None:
        got = out["out"]
        pairs = (zip(got, want) if isinstance(want, (tuple, list))
                 else ((got, want),))
        err = max(max_abs_err(g, w) for g, w in pairs if w is not None)
    CHECKED.setdefault(build_name, []).append(dict(
        kernel=kernel, label=label, count=out["count"], ms=ms, err=err,
        row=row))
    notes = {k: out[k] for k in ("grown", "words", "tile", "launches")
             if k in out}
    log(f"[check] {kernel}.out_of_bounds count={out['count']} at {label}"
        + (f" {notes}" if notes else "")
        + (f"; output vs plain {err}" if err is not None else "")
        + (f"; first records (line, operand, byte offset, operand bytes, "
           f"access bytes) {out['loads'][:8]}" if out["count"] else ""))
    return out


def assert_in_bounds(*names) -> None:
    """Every run of the checked builds ``names`` so far counted no access
    outside its operands, and every output equals the plain version's."""
    runs = [(n, r) for n in names for r in CHECKED.get(n, [])]
    assert runs, names
    bad = [(r["kernel"], r["label"], r["count"], r["err"]) for _, r in runs
           if r["count"] or r["err"]]
    assert not bad, bad


def checked_build_rows(table) -> list:
    """The kernels line's rows of the builds in ``CHECKED``: not on the
    main path (no launches); ms is the checked calls' that repeat a
    main-path row's call (summed where that call is several launches),
    beside that row's plain, bound and library times."""
    by_name = {r["name"]: r for r in table}
    rows = []
    for name, runs in CHECKED.items():
        mine = [r for r in runs if r["row"] is not None]
        if not mine:
            continue
        at = by_name[mine[0]["row"]]
        ms = sum(r["ms"] for r in mine)
        errs = [r["err"] for r in runs if r["err"] is not None]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + CHECKED_SOURCES[name],
            "replaces": at["replaces"], "launches": 0,
            "max_abs_err": max(errs) if errs else None, "ms": ms,
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "tile": None})
        log(f"[time] {name}: {ms:.4f} ms a checked call at "
            f"{mine[0]['kernel']} {mine[0]['label']}"
            + (f" ({len(mine)} launches)" if len(mine) > 1 else "")
            + f" (the row {at['name']}: {at['ms']:.4f} ms); "
            f"{sum(r['count'] for r in runs)} accesses outside the operands "
            f"over {len(runs)} launches")
    return rows


def bounds_controls(device, pv, pos) -> dict:
    """The negative control of the checked builds that take
    ``csrc/bounds_check.cuh``: each launched with one operand's range left
    out of the ranges it sets, as if its kernel read or wrote past that
    operand, must count accesses, and end (a next link read as 0 once sent
    the checked walk round row 0 for ever). The per-page GET runs on the
    paged arena ``pv`` at positions ``pos``. Returns the counts; none of
    these runs joins ``CHECKED``."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import bsearch_probe as bp_mod
    from repro_torch.kernels import csr_walk as cw_mod
    from repro_torch.kernels import geo_gaps as geo_mod
    from repro_torch.kernels import prefix_sum as ps_mod
    from repro_torch.kernels import tree_probe as tp_mod

    g = torch.Generator(device=device)
    g.manual_seed(1)
    x = torch.randint(0, 9, (20_000,), generator=g, device=device,
                      dtype=torch.int32)
    xf = torch.rand((20_000,), generator=g, device=device,
                    dtype=torch.float64)
    u = torch.rand((20_000,), generator=g, device=device)
    w = torch.randint(0, 30, (100_000,), generator=g, device=device,
                      dtype=torch.int32)
    pref = torch.cat([w.new_zeros(1), torch.cumsum(w, 0, dtype=torch.int32)])
    q = torch.sort(torch.randint(0, int(pref[-1]), (5_000,), generator=g,
                                 device=device, dtype=torch.int32)).values
    # chains of ten rows; row 0 of weight 0
    wt = torch.randint(0, 3, (1_000,), generator=g, device=device)
    wt[0] = 0
    rows = torch.arange(1_000, device=device)
    nxt = torch.where(rows % 10 == 9, -1, rows + 1).to(torch.int32)
    hd = (torch.arange(300, device=device) // 30 * 10).to(torch.int32)
    idx = torch.randint(0, 12, (300,), generator=g, device=device)
    cases = (
        ("scan_i32", "status", lambda: ps_mod.out_of_bounds(x)),
        ("scan_i32", "out", lambda: ps_mod.out_of_bounds(x)),
        ("scan_f64", "status", lambda: ps_mod.out_of_bounds(xf)),
        ("scan_f64", "x", lambda: ps_mod.out_of_bounds(xf)),
        ("geo_gaps", "x", lambda: geo_mod.out_of_bounds(u, GEO_P)),
        ("bsearch_probe", "pref", lambda: bp_mod.out_of_bounds(pref, q)),
        ("bsearch_probe", "out", lambda: bp_mod.out_of_bounds(pref, q)),
        ("csr_walk", "nxt", lambda: cw_mod.out_of_bounds(wt, nxt, hd, idx)),
        ("csr_walk_cached", "nxt",
         lambda: cw_mod.out_of_bounds(wt, nxt, hd, idx, True)),
        ("csr_walk_cached", "row",
         lambda: cw_mod.out_of_bounds(wt, nxt, hd, idx, True)),
        ("tree_probe_paged_pages", "page 1",
         lambda: tp_mod.paged_out_of_bounds(pv, pos)))
    real = build.checked_run
    counts = {}
    try:
        for kernel, left_out, fn in cases:
            build.checked_run = (lambda left_out: lambda cs, launch, cg, ops,
                                 dev, records: real(cs, launch, cg, [
                                     (n, t) for n, t in ops if n != left_out],
                                     dev, records))(left_out)
            out = fn()
            counts[f"{kernel} without {left_out}"] = out["count"]
            log(f"[check] negative control: {kernel}.out_of_bounds with the "
                f"range of {left_out} left out: count={out['count']}; first "
                f"records {out['loads'][:2]}")
    finally:
        build.checked_run = real
    assert all(counts.values()), counts
    return counts


def scan_bounds_ragged(device, gen, extra=()) -> None:
    """The scan's checked build at ragged sizes, each entry on a stream of
    its own, whose scratch the first launch makes and each larger size
    grows: one element, each tile of the entry less one and plus one (the
    floats' ``TILE``, the look-back's two tiles), the ``extra`` sizes;
    then, at two of its largest tiles, an input and an output that each
    start one element into their allocations (4 bytes, 8 in float64: the
    scalar load and store paths)."""
    import torch

    from repro_torch.kernels import geo_gaps as geo_mod
    from repro_torch.kernels import prefix_sum as ps_mod

    T, Ts, Tf = (ps_mod.LOOK_BACK_TILE, ps_mod.LOOK_BACK_SMALL_TILE,
                 ps_mod.TILE)
    cases = {"scan_i32": (torch.int32, (Ts, T)),
             "geo_gaps": (torch.float32, (Ts, T)),
             "scan_f32": (torch.float32, (Tf,)),
             "scan_f64": (torch.float64, (Tf,))}
    main_stream = torch.cuda.current_stream(device)
    for entry, (dt, tiles) in cases.items():
        geo = entry == "geo_gaps"

        def data(m):
            if dt == torch.int32:
                return torch.randint(-2**31, 2**31, (m,), generator=gen,
                                     device=device, dtype=dt)
            return torch.rand((m,), generator=gen, device=device, dtype=dt)

        sizes = sorted({1, *(t + d for t in tiles for d in (-1, 1)),
                        *extra})
        side = torch.cuda.Stream(device)
        side.wait_stream(main_stream)
        with torch.cuda.stream(side):
            for m in sizes + [None]:
                out = None
                label = f"n {m}"
                if m is None:
                    m = 2 * max(tiles)
                    x = data(m + 1)[1:]
                    out = torch.empty(m + 1, device=device, dtype=(
                        torch.int32 if geo else dt))[1:]
                    label = (f"n {m}, input and output one element into "
                             "their allocations")
                else:
                    x = data(m)
                want = (geo_mod.geo_gaps_plain(x, GEO_P) if geo
                        else ps_mod.prefix_sum_plain(x))
                bounds_checked(
                    "scan_checked", entry, label + " (a stream of its own)",
                    (lambda: geo_mod.out_of_bounds(x, GEO_P, out)) if geo
                    else (lambda: ps_mod.out_of_bounds(x, out)), want)
        main_stream.wait_stream(side)
        side.synchronize()


def bsearch_bounds_ragged(pref, q, device, policy=None) -> None:
    """The bsearch kernel's checked build on slices of the sorted queries
    ``q`` at each instance's tile (256, 512, 1,024 and 2,048 queries) less
    one and plus one, at one query, and on a view one query into its
    allocation, each at the tile ``autotune.tile_for`` resolves for its
    size."""
    from repro_torch.kernels import bsearch_probe as bp_mod
    from repro_torch.kernels.autotune import tile_for

    cases = {f"n {m}": q[:m] for m in (1, 255, 257, 511, 513, 1023, 1025,
                                       2047, 2049)}
    cases["n 3109, a view one query into its allocation"] = q[1:3110]
    for label, qq in cases.items():
        br = tile_for("bsearch_probe", qq.numel(), policy, device)
        bounds_checked("bsearch_probe_checked", "bsearch_probe",
                       f"{label} (block_rows {br})",
                       lambda: bp_mod.out_of_bounds(pref, qq, br),
                       bp_mod.bsearch_probe_plain(pref, qq))


def paged_bounds_ragged(pv, pos) -> None:
    """The per-page GET's checked build on slices of the positions
    ``pos``: one probe, a block of 256 less one and plus one, and a view
    one probe into its allocation."""
    from repro_torch.kernels import tree_probe as tp_mod

    cases = {f"n {m}": pos[:m] for m in (1, 255, 257)}
    cases["n 1000, a view one probe into its allocation"] = pos[1:1001]
    for label, pp in cases.items():
        bounds_checked("tree_probe_paged_checked", "tree_probe_paged_pages",
                       label, lambda: tp_mod.paged_out_of_bounds(pv, pp),
                       tp_mod.tree_probe_plain(pv.buffer, pp, pv.layout))


def csr_bounds_ragged(weight, nxt, hd, idx) -> None:
    """Both CSR walk kernels' checked build on the first and the last
    probes of an edge: one probe, the caching kernel's tile (128) and the
    plain walk's block (256) less one and plus one, and a view one probe
    into its allocation."""
    from repro_torch.kernels import csr_walk as cw_mod

    m_all = hd.numel()
    cases = {}
    for m in (1, 127, 129, 255, 257):
        if m <= m_all:
            cases[f"the first {m} probes"] = (hd[:m], idx[:m])
            cases[f"the last {m} probes"] = (hd[m_all - m:], idx[m_all - m:])
    m = min(1000, m_all - 1)
    cases[f"{m} probes, a view one probe into its allocation"] = (
        hd[1:m + 1], idx[1:m + 1])
    for label, (h, i) in cases.items():
        want = cw_mod.csr_walk_plain(weight, nxt, h, i)
        for cached in (False, True):
            bounds_checked(
                "csr_walk_checked",
                "csr_walk_cached" if cached else "csr_walk", label,
                lambda: cw_mod.out_of_bounds(weight, nxt, h, i, cached,
                                             stats=cached), want)


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
    # float32 at D 128 (G 16 over one KV head) and D 256 (gemma3-1b's
    # widths), ragged S: a query tile of one row past 64, and 1,000
    for Dw, Hw, KVw in ((128, 16, 1), (Dg, Hg, KVg)):
        for Sw in (65, 1000):
            qw, kw, vw = (randn((1, Hw, Sw, Dw), f32),
                          randn((1, KVw, Sw, Dw), f32),
                          randn((1, KVw, Sw, Dw), f32))
            for causal in (True, False):
                pre_cases[f"float32 H={Hw} KV={KVw} D={Dw} S={Sw} "
                          f"{'causal' if causal else 'full'}"] = (
                    qw, kw, vw, causal, F32_PREFILL_TOL)
    # the float32 kernel's other paths: G 1, and G 16 (the wide accumulator
    # instance) with a bias row masked everywhere (V's mean, not NaN)
    masked = padding_bias(2, Sf)
    masked[0] = -1e30
    dec_cases.update({
        f"float32 G=1 B=2 KV=2 D=128 S={Sf}": (
            randn((2, 2, 128), f32), randn((2, 2, Sf, 128), f32),
            randn((2, 2, Sf, 128), f32), padding_bias(2, Sf), F32_DECODE_TOL),
        f"float32 G=16 B=2 KV=1 D=128 S={Sf}, row 0 masked everywhere": (
            randn((2, 16, 128), f32), randn((2, 1, Sf, 128), f32),
            randn((2, 1, Sf, 128), f32), masked, F32_DECODE_TOL)})
    keys = [threefry.key(4000 + s) for s in range(GEO_KEYS)]
    if device.type == "cuda":
        torch.cuda.synchronize()

    # -- the main path: the ops wrappers ---------------------------------------
    reset_counts(kernels)
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
    launches = launch_counts(kernels)
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
    if device.type == "cuda":
        # The scan's checked build at the phase's sizes (int32 as the
        # prefix_sum row's call; float32, float64 and GEO's lanes), then at
        # ragged sizes and across the look-back's switch of tile, each
        # entry on a stream of its own whose scratch grows
        for entry, x, want in (("scan_i32", w_i32, want_i32),
                               ("scan_f32", w_rand, want_rand),
                               ("scan_f64", w_rand64, want_rand64)):
            bounds_checked("scan_checked", entry, f"D, n {n}",
                           lambda: ps_mod.out_of_bounds(x), want,
                           row="prefix_sum" if entry == "scan_i32" else None)
        bounds_checked("scan_checked", "geo_gaps", f"D, {lanes} lanes",
                       lambda: geo_mod.out_of_bounds(u0, GEO_P),
                       geo_mod.geo_gaps_plain(u0, GEO_P))
        scan_bounds_ragged(device, gen, extra=(33 * T + 7, switch - 1,
                                               switch))
        assert_in_bounds("scan_checked")

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
    checked_f32 = {}
    if device.type == "cuda":
        # the float32 kernel's checked build at the smollm-135m S 1,000 rows
        for causal in (True, False):
            oob = pre_mod.out_of_bounds(qs, ks, vs, causal)
            err = close(oob["out"], pre_mod.flash_prefill_plain(qs, ks, vs,
                                                                causal),
                        F32_PREFILL_TOL)
            log(f"[check] flash_prefill_checked float32 smollm-135m B=2 "
                f"S=1000 {'causal' if causal else 'full'}: {oob['count']} "
                f"accesses outside the operands {oob['loads'][:4]}; its "
                f"output vs plain {err:.3g}")
            assert oob["count"] == 0, oob
            checked_f32["causal" if causal else "full"] = oob["count"]

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
             "flash_prefill_checked": checked_f32,
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
    if device.type == "cuda":
        # a float32 decode call is one device operation: ten calls under the
        # profiler show the split kernel alone (no combine, no memset)
        events = device_events(call["flash_decode_f32"], 10)
        names = sorted({e.key for e in events})
        count = sum(e.count for e in events)
        log(f"[check] flash_decode float32: ten calls profiled, {count} "
            f"device operations: {names}")
        assert 0 < count <= 10 and all("flash_decode_f32_kernel" in n
                                       for n in names), names
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
    from repro_torch.data import make_corpus_db
    from repro_torch.engine import QueryEngine
    from repro_torch.kernels import fused_draw as fd_mod
    from repro_torch.kernels import prefix_sum as ps_mod
    from repro_torch.kernels import threefry
    from repro_torch.launch import serve

    on_card = device.type == "cuda"
    (tabA, engA, planA), (tabB, engB, planB), (tabC, engC, planC) = (
        configs[k] for k in "ABC")
    fullA, fullB, fullC = fulls
    launches = {}

    def main_path(label, fn):
        reset_counts(kernels)
        out = fn()
        launches[label] = launch_counts(kernels)
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
    # serve --mode join's corpus (DEMO_CORPUS: 64 clusters): a root of 64
    # rows takes 128 arrival lanes, an eighth of a tile, the shape whose
    # last tile once read past the scratch (phase G's G.cli)
    demo = make_corpus_db(**serve.DEMO_CORPUS, device=device)
    demo_plan = QueryEngine(demo, device=device,
                            kernel_policy=engB.kernel_policy).compile
    planQ = demo_plan(JoinQuery((Atom.of("ClusterQuality", "clust", "p"),),
                                prob_var="p"))
    planQD = demo_plan(JoinQuery((Atom.of("ClusterQuality", "clust", "p"),
                                  Atom.of("Doc", "doc", "clust")),
                                 prob_var="p"))
    demo_cases = (
        ("the demo's ClusterQuality, a bucket of 64", planQ, keys64,
         "exprace"),
        ("the demo's ClusterQuality, one key", planQ, keysB[:1], "exprace"),
        ("the demo's ClusterQuality, flat PTBERN", planQ, keysB,
         "ptbern_flat"),
        ("the demo's ClusterQuality |><| Doc", planQD, keysB, "exprace"))
    # (the CPU rehearsal's small draw budget routes the corpus elsewhere)
    assert planQ.route == planQD.route == "fused" or not on_card
    if planQD.route != "fused":
        demo_cases = demo_cases[:3] if planQ.route == "fused" else ()
    tiles = {"staged": 0, "fallback": 0}
    bounds = {"launches": 0, "loads": 0}
    for label, plan, keys, method in (
            ("B", planB, keysB, "exprace"),
            ("B, flat PTBERN", planB, keysB, "ptbern_flat"),
            ("B, one key", planB, keysB[:1], "exprace"),
            ("C", planC, keysC, "exprace"),
            ("C, a bucket of 64", planC, keys64, "exprace"),
            ("B at p = 0.01", planS, keysB, "exprace"),
            ("B, Title |><| Cast", planTC, keysB, "exprace"),
            ("five relations", plan5, keysB[:4], "exprace"),
            *demo_cases):
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
            # the checked build: every load inside the launch's operands
            scalars = torch.stack([want[2].to(torch.int32),
                                   want[3].to(torch.int32)], 1)
            for arena in (pk.arena, None):
                out = bounds_checked(
                    "fused_draw_checked", "fused_draw_batch" if arena
                    is not None else "fused_sample_batch",
                    f"{label} ({len(keys)} keys, {method})",
                    lambda: fd_mod.out_of_bounds(
                        arena, None, plan.draw_params,
                        layout=None if arena is None else pk.layout,
                        keys=keys, **kw),
                    (want[0] if arena is not None else None, want[1],
                     scalars),
                    row=("fused_draw_batch" if arena is not None
                         and label == "B" else None))
                bounds["launches"] += 1
                bounds["loads"] += out["count"]
            del scalars
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
    if on_card:
        log(f"[check] the checked build (FD_CHECK_BOUNDS) over the same "
            f"{bounds['launches']} launches, fused_draw_batch and "
            f"fused_sample_batch: {bounds['loads']} loads outside their "
            f"operands")
        assert_in_bounds("fused_draw_checked")
    assert tiles["staged"] > 0 and tiles["fallback"] > 0, tiles
    del planS, planTC, plan5, planQ, planQD, demo
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
    if on_card:
        bounds_checked("scan_checked", "scan_f64",
                       f"A's {xA.numel()} masses",
                       lambda: ps_mod.out_of_bounds(xA),
                       ps_mod.prefix_sum_plain(xA))
        assert_in_bounds("scan_checked")
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
        reset_counts(kernels)
        out = fn()
        launches[label] = launch_counts(kernels)
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
    if on_card:
        # the walks' checked build, both modes: every edge of the full
        # join (csr_walk's row repeats its call) and of the draw, the
        # skewed edge (with the run counts), ragged slices of it
        for label, edges in (("full join", edges_full), ("draw", edges_draw)):
            for e in edges:
                for cached in (False, True):
                    bounds_checked(
                        "csr_walk_checked",
                        "csr_walk_cached" if cached else "csr_walk",
                        f"F.CSR at A, {label}, edge {e.name} "
                        f"({e.hd.numel()} probes)",
                        lambda: cw_mod.out_of_bounds(
                            e.child.weight, e.child.nxt, e.hd, e.idx,
                            cached), (e.row, e.rem),
                        row=("csr_walk" if label == "full join"
                             and not cached else None))
        for cached in (False, True):
            bounds_checked(
                "csr_walk_checked", "csr_walk_cached" if cached
                else "csr_walk", f"F.CSR, the skewed edge ({skew[2].numel()} "
                "probes, run counts on)",
                lambda: cw_mod.out_of_bounds(*skew, cached, stats=True),
                plain)
        csr_bounds_ragged(*skew)
        assert_in_bounds("csr_walk_checked")
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
        reset_counts(kernels)
        out = fn()
        sync()
        launches[label] = launch_counts(kernels)
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
        reset_counts(kernels)
        out = fn()
        sync()
        launches[label] = launch_counts(kernels)
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


# bf16 logits of the kernel path against the plain path's (phase I): about
# twice the spread that one bf16 ulp of attention noise on half the outputs
# gives at full width and depth (0.045 at S 256 on the CPU), a fifth of the
# logits' standard deviation (0.48)
LM_PATH_TOL = 0.1
LM_PREFILL_TOL = 5e-3  # float32 prefill and decode against forward
LM_ARCH = "smollm_135m"


class counting_calls:
    """Counts the calls of ``attr`` of each module in ``targets`` (a
    list of ``(module, attr)``) while active, and restores them after."""

    def __init__(self, targets):
        self.targets, self.calls, self.saved = targets, {}, []

    def __enter__(self):
        for mod, attr in self.targets:
            fn = getattr(mod, attr)
            key = f"{mod.__name__.rsplit('.', 1)[-1]}.{attr}"
            self.calls[key] = 0

            def wrapped(*a, _fn=fn, _key=key, **kw):
                self.calls[_key] += 1
                return _fn(*a, **kw)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        return self.calls

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        return False


def attention_split(events) -> dict:
    """Device ms of ``torch.profiler`` events by kind: the attention
    kernels, the matrix products (cuBLAS), the rest."""
    split = {"attention": 0.0, "matmul": 0.0, "rest": 0.0}
    for e in events:
        split[kernel_kind(e.key)] += e.self_device_time_total / 1e3
    return split


def kernel_kind(name: str) -> str:
    """A device kernel's kind by its name: "attention" (the attention
    kernels), "matmul" (cuBLAS and CUTLASS products) or "rest"."""
    name = name.lower()
    if "flash_" in name:
        return "attention"
    if any(s in name for s in ("gemm", "gemv", "xmma", "nvjet", "cutlass",
                               "matmul", "splitk")):
        return "matmul"
    return "rest"


def run_lm(args, device, kernels, kernel_policy=None):
    """Phase I: LM serving at smollm-135m's published config (30 layers,
    d_model 576, H 9, KV 3, head dim 64, vocabulary 49,152; 135 M float32
    parameters drawn from ``--seed``, bf16 compute): ``serve_batch`` of
    ``--lm-requests`` prompts of ``--lm-prompt-min`` to ``--lm-prompt-max``
    tokens (drawn from ``--seed``), ``--lm-new`` greedy tokens each. The
    main path counts its launches: one ``flash_prefill`` a layer for the
    prefill and one ``flash_decode`` a layer a step, and no call of a plain
    attention version. Then the checks: at layers 0 and L-1, in the
    prefill and in one decode step, each kernel's output on the model's
    own q, k and v against its plain version (phase D's bf16 tolerance);
    at float32 compute, ``prefill``'s last logits and one ``decode_step``
    against ``forward`` (5e-3); in bf16 the kernel path's prefill logits
    against the plain path's (a disabled policy), within ``LM_PATH_TOL``.
    Then the times of a warm ``serve_batch``, the kernels at its shapes
    beside SDPA and, with ``--profile``, the device time of a prefill and
    of a decode step by kind. Returns the launches and the numbers."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.config import DEFAULT_POLICY, KernelPolicy
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, forward, init_model, prefill

    on_card = device.type == "cuda"
    policy = kernel_policy or DEFAULT_POLICY
    e2e = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = configs.get_config(LM_ARCH)
    L = cfg.n_layers
    # what earlier phases still hold, left out of phase I's peak
    held = torch.cuda.memory_allocated(device) if on_card else 0
    e2e["held_bytes"] = held
    t0 = time.perf_counter()
    model = init_model(cfg, args.seed, device=device, policy=policy)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[I] {cfg.name}: {L} layers, d_model {cfg.d_model}, H {cfg.n_heads}, "
        f"KV {cfg.n_kv_heads}, head dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {n_params:,} {cfg.param_dtype} parameters (seed "
        f"{args.seed}), {cfg.compute_dtype} compute; drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(args.seed + 25)
    lens = rng.integers(args.lm_prompt_min, args.lm_prompt_max + 1,
                        args.lm_requests)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]

    def requests():
        return [serve.Request(prompt=list(p), max_new=args.lm_new)
                for p in prompts]

    plain_targets = [(dec_mod, "flash_decode_plain"),
                     (pre_mod, "flash_prefill_plain"),
                     (ref, "flash_decode_ref"), (ref, "flash_prefill_ref"),
                     (attn_mod, "blockwise_attention")]

    # -- the main path: serve_batch -------------------------------------------
    reset_counts(kernels)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    stats = {}
    with counting_calls(plain_targets) as plain_calls:
        t0 = time.perf_counter()
        done = serve.serve_batch(LM_ARCH, requests(), seed=args.seed,
                                 reduced=False, params=model, stats=stats)
        sync()
        cold_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    log(f"[I] launches {({k: v for k, v in launches.items() if v})}; plain "
        f"attention calls {plain_calls}")
    log(f"[I] instances (tuned tiles) {window_tiles(kernels)}")
    if on_card:
        assert launches["flash_prefill"] == L, launches
        assert launches["flash_decode"] == L * args.lm_new, launches
        assert all(v == 0 for k, v in launches.items()
                   if k not in ("flash_prefill", "flash_decode")), launches
        assert all(v == 0 for v in plain_calls.values()), plain_calls
        e2e["peak_device_bytes"] = int(
            torch.cuda.max_memory_allocated(device)) - held
    S = int(max(lens))
    assert all(len(r.out) == args.lm_new and
               all(0 <= t < cfg.vocab for t in r.out) for r in done)
    log(f"[I] served {len(done)} requests (prompts {sorted(int(n) for n in lens)}"
        f" tokens, padded to {S}; cache {stats['cache_len']}), {args.lm_new} "
        f"tokens each, cold in {cold_s:.2f} s; request 0 -> "
        f"{done[0].out[:8]}")

    # -- checks ------------------------------------------------------------------
    B = len(prompts)
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p)
    toks = toks.to(device)
    total = S + args.lm_new + 1
    seen = {"prefill": [], "decode": []}

    def recording(kind, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            n = len(seen[kind])
            seen[kind].append((a, kw, out) if n % L in (0, L - 1) else None)
            return out
        return wrapped

    saved = ops.prefill_attention, ops.decode_attention
    ops.prefill_attention = recording("prefill", saved[0])
    ops.decode_attention = recording("decode", saved[1])
    try:
        with torch.no_grad():
            logits_k, cache = prefill(model, toks, total)
            decode_step(model, cache, toks[:, -1:], S)
    finally:
        ops.prefill_attention, ops.decode_attention = saved
    sync()
    errs = {"flash_prefill": 0.0, "flash_decode": 0.0}
    for kind, plain in (("prefill", pre_mod.flash_prefill_plain),
                        ("decode", dec_mod.flash_decode_plain)):
        assert len(seen[kind]) == L, (kind, len(seen[kind]))
        for layer in (0, L - 1):
            a, kw, out = seen[kind][layer]
            want = plain(*a, kw["causal"]) if kind == "prefill" else plain(*a)
            err = close(out, want, BF16_TOL)
            name = f"flash_{kind}"
            errs[name] = max(errs[name], err)
            log(f"[check] I {name} at layer {layer} on the model's own q, k, "
                f"v ({' x '.join(str(d) for d in a[0].shape)} queries over "
                f"{a[1].shape[2]} keys): kernel vs plain max_abs_err "
                f"{err:.3g} (rtol, atol {BF16_TOL})")
    if on_card:  # the prefill's loads at its padded serving shapes
        a, kw, _ = seen["prefill"][0]
        oob = pre_mod.out_of_bounds(*a, kw["causal"])
        log(f"[check] I flash_prefill_tc checked build at "
            f"{' x '.join(str(d) for d in a[0].shape)}: {oob['count']} "
            f"accesses outside q, k, v and the output {oob['loads'][:4]}")
        assert oob["count"] == 0, oob
        e2e["out_of_bounds"] = oob["count"]
    del seen, cache
    # float32 compute, full width and depth: prefill and one decode step
    # against forward, on the first two prompts
    m32 = init_model(dataclasses.replace(cfg, compute_dtype="float32"),
                     args.seed, device=device, policy=policy)
    t2 = toks[:2]
    with torch.no_grad():
        lp, c32 = prefill(m32, t2, S + 2)
        lf, _ = forward(m32, t2)
        err_pre = float((lp[:, 0] - lf[:, -1]).abs().max())
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        ld, _ = decode_step(m32, c32, nxt, S)
        lf2, _ = forward(m32, torch.cat([t2, nxt], dim=1))
        err_dec = float((ld[:, 0] - lf2[:, -1]).abs().max())
    log(f"[check] I float32 at full width and depth, B 2, S {S}: prefill's "
        f"last logits vs forward's max_abs_err {err_pre:.3g}; a decode_step "
        f"at {S} vs forward over {S + 1} tokens {err_dec:.3g} (bound "
        f"{LM_PREFILL_TOL})")
    assert err_pre <= LM_PREFILL_TOL and err_dec <= LM_PREFILL_TOL
    del m32, lp, lf, ld, lf2, c32
    # bf16: the kernel path's prefill logits against the plain path's
    model.policy = KernelPolicy(enabled=False)
    try:
        with torch.no_grad():
            logits_p, _ = prefill(model, toks, total)
    finally:
        model.policy = policy
    err_path = float((logits_k - logits_p).abs().max())
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    log(f"[check] I bf16 prefill logits, kernel path vs plain path (B {B}, S "
        f"{S}): max_abs_err {err_path:.4g} (bound {LM_PATH_TOL}; logits' sd "
        f"{float(logits_p.float().std()):.3f}), argmax agree on {agree:.3f} "
        f"of the rows")
    assert err_path <= LM_PATH_TOL
    e2e.update(attention_errs=errs, float32_prefill_err=err_pre,
               float32_decode_err=err_dec, bf16_path_err=err_path,
               bf16_path_argmax_agree=agree)
    del logits_k, logits_p

    # -- times: a warm serve_batch, then the kernels at its shapes -----------------
    stats = {}
    t0 = time.perf_counter()
    serve.serve_batch(LM_ARCH, requests(), params=model, stats=stats)
    sync()
    wall_s = time.perf_counter() - t0
    dec = stats["decode_ms"]
    n_tok = B * args.lm_new
    e2e.update(batch=B, prompt_lens=[int(n) for n in lens], padded_len=S,
               new_tokens=args.lm_new, cold_s=cold_s, wall_s=wall_s,
               prefill_ms=stats["prefill_ms"], decode_step_ms=dec,
               decode_step_mean_ms=sum(dec) / len(dec),
               tokens_per_s=n_tok / wall_s,
               prompt_tokens_per_s=B * S / (stats["prefill_ms"] / 1e3))
    log(f"[time] I serve_batch (warm): {wall_s * 1e3:.2f} ms for {n_tok} new "
        f"tokens ({e2e['tokens_per_s']:.1f} tokens/s); prefill of {B} x {S} "
        f"{stats['prefill_ms']:.3f} ms ({e2e['prompt_tokens_per_s']:.0f} "
        f"prompt tokens/s); decode step mean {e2e['decode_step_mean_ms']:.3f} "
        f"ms (min {min(dec):.3f}, max {max(dec):.3f})"
        + (f"; peak device memory of the cold run "
           f"{e2e['peak_device_bytes'] / 2**30:.2f} GiB over the "
           f"{held / 2**30:.2f} GiB earlier phases hold" if on_card else ""))
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 26)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16)

    qp, kp, vp = randn(B, H, S, D), randn(B, KV, S, D), randn(B, KV, S, D)
    qd, kd, vd = randn(B, H, D), randn(B, KV, total, D), randn(B, KV, total, D)
    bias = attn_mod.decode_bias(B, total, S, 0, device)
    k_times = {
        "prefill_ms": timed(lambda: ops.prefill_attention(qp, kp, vp),
                            args.reps, device),
        "prefill_library_ms": library_timed(
            lambda: F.scaled_dot_product_attention(qp, kp, vp, is_causal=True,
                                                   enable_gqa=True),
            args.reps, device, "I prefill SDPA"),
        "prefill_bound_ms": bound(2 * (2 * qp.numel() + kp.numel()
                                       + vp.numel()),
                                  2 * qp.numel() * S, BF16_TC_OPS_PER_S)[0],
        "decode_ms": timed(lambda: ops.decode_attention(qd, kd, vd, bias),
                           args.reps, device),
        "decode_library_ms": library_timed(
            lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kd, vd, attn_mask=(bias == 0)[:, None, None],
                enable_gqa=True), args.reps, device, "I decode SDPA"),
        "decode_bound_ms": bound(2 * (kd.numel() + vd.numel() + 2 * qd.numel())
                                 + 4 * bias.numel(),
                                 4 * qd.numel() * total, BF16_TC_OPS_PER_S)[0],
        "prefill_plain_ms": timed(lambda: pre_mod.flash_prefill_plain(
            qp, kp, vp, True), 1, device),
        "decode_plain_ms": timed(lambda: dec_mod.flash_decode_plain(
            qd, kd, vd, bias), 1, device)}
    e2e["kernel_times"] = k_times
    lib = {k: "refused" if v is None else f"{v:.4f}"
           for k, v in k_times.items()}
    log(f"[time] I flash_prefill at B {B}, H {H}, KV {KV}, S {S}, D {D} "
        f"causal: {k_times['prefill_ms']:.4f} ms (plain "
        f"{lib['prefill_plain_ms']}, SDPA {lib['prefill_library_ms']}, bound "
        f"{lib['prefill_bound_ms']}); flash_decode over {total} keys: "
        f"{k_times['decode_ms']:.4f} ms (plain {lib['decode_plain_ms']}, SDPA "
        f"{lib['decode_library_ms']}, bound {lib['decode_bound_ms']}); x {L} "
        f"layers: "
        f"{L * k_times['prefill_ms']:.3f} ms a prefill, "
        f"{L * k_times['decode_ms']:.3f} ms a step")
    del qp, kp, vp, qd, kd, vd
    if on_card and args.profile:
        with torch.no_grad():
            _, cache = prefill(model, toks, total)
            sync()
            nxt = toks[:, -1:]
            windows = {
                "prefill": lambda: prefill(model, toks, total),
                "decode step": lambda: decode_step(model, cache, nxt, S)}
            for label, fn in windows.items():
                wall = wall_ms(fn, device)
                events = device_events(fn, 1)
                split = attention_split(events)
                busy = sum(split.values())
                n_ops = sum(e.count for e in events)
                e2e[f"profile_{label}"] = dict(split, busy_ms=busy,
                                               wall_ms=wall, device_ops=n_ops,
                                               idle_share=1 - busy / wall)
                log(f"[profile] I {label}: device busy {busy:.3f} ms of "
                    f"{wall:.3f} ms warm wall (idle share "
                    f"{1 - busy / wall:.3f}): attention kernels "
                    f"{split['attention']:.3f}, matrix products "
                    f"{split['matmul']:.3f}, the rest {split['rest']:.3f}; "
                    f"{n_ops} device operations ({len(events)} kernels by "
                    "name)")
                for e in sorted(events, key=lambda e: -e.self_device_time_total
                                )[:6]:
                    log(f"[profile] I {label}:   "
                        f"{e.self_device_time_total / 1e3:8.3f} ms  "
                        f"x{e.count:<4d} {e.key[:80]}")
    del model
    if on_card:
        torch.cuda.empty_cache()
    return launches, e2e


# Phase M: the seven architectures that fit one H100 (configs/*, their
# published configs, not cut), distinct code paths first and the biggest
# model last; llama3-405b (756 GiB) and llama4-scout (201 GiB) need several
# cards.
ARCHS_M = ("gemma3_1b", "zamba2_1p2b", "whisper_small", "olmoe_1b_7b",
           "rwkv6_7b", "starcoder2_7b", "llama32_vision_11b")
# Each architecture's attention calls at its published config (the port's
# ``attention_calls``, models/transformer.py): (causal, non-causal,
# blockwise) a prefill and decodes a step. gemma3-1b: 21 local
# layers (window 512) and 5 global; zamba2: its shared block at 2 of 38
# layers; whisper: 12 encoder layers over 1,500 frames and 12 cross layers;
# llama-3.2-vision: 32 dense layers and 8 cross layers over 6,400 tokens.
ARCH_ROUTES = {"gemma3_1b": (5, 0, 21, 26), "zamba2_1p2b": (2, 0, 0, 2),
               "whisper_small": (12, 12, 12, 24),
               "olmoe_1b_7b": (16, 0, 0, 16), "rwkv6_7b": (0, 0, 0, 0),
               "starcoder2_7b": (32, 0, 0, 32),
               "llama32_vision_11b": (40, 0, 8, 48)}
# Check (c) runs on these: the windowed cache, the Mamba2 and RWKV6 states
# and the cross cache; over B 2 x ARCH_CHECK_SEQ tokens, past gemma3-1b's
# window (512) and two Mamba2 chunks (256)
ARCH_F32_CHECK = ("gemma3_1b", "zamba2_1p2b", "whisper_small", "rwkv6_7b")
ARCH_CHECK_SEQ = 600
# phase M's requests: prompts of 128-512 tokens, greedy tokens each
ARCH_REQUESTS, ARCH_PROMPT_MIN, ARCH_PROMPT_MAX, ARCH_NEW = 4, 128, 512, 16
# EpiQL on the card (the paper's Example 1.1)
EPIQL_POP, EPIQL_DAYS = 100_000, 5
# EpiQL's day 0 on the card against the CPU's plain pipeline, a fraction
# of E[k] (the CPU test holds that pipeline to the reference's within it)
EPIQL_ROUTE_TOL = 1e-4
# models drawn on the host at once (each by one CPU generator), and the
# host memory left free while another is drawn
DRAW_WORKERS, HOST_RESERVE = 2, 16 << 30


def proc_bytes(path: str, key: str):
    """A ``key: N kB`` line of ``path`` in bytes (``MemAvailable`` of
    ``/proc/meminfo``, ``VmHWM`` of ``/proc/self/status``), or ``None``
    where the file does not say."""
    try:
        with open(path) as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def host_available():
    """The host's available memory in bytes, or ``None``."""
    return proc_bytes("/proc/meminfo", "MemAvailable")


class ranged:
    """Runs each ``(module, attr, label)`` function of ``targets`` inside a
    ``torch.profiler`` range named ``label`` while active."""

    def __init__(self, targets):
        self.targets, self.saved = targets, []

    def __enter__(self):
        import torch

        for mod, attr, label in self.targets:
            fn = getattr(mod, attr)

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        return False


class attention_routes:
    """Counts ``ops.prefill_attention`` by ``causal`` and
    ``ops.decode_attention`` by whether a bias masks it (self) or not
    (memory), and keeps each kind's first and last call (operands, output)
    when ``keep``."""

    def __init__(self, keep=False):
        self.keep, self.n, self.calls = keep, {}, {}

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.saved = ops, (ops.prefill_attention,
                                     ops.decode_attention)

        def record(kind, a, kw, out):
            self.n[kind] = self.n.get(kind, 0) + 1
            if self.keep:
                first, _ = self.calls.get(kind, (None, None))
                self.calls[kind] = (first or (a, kw, out), (a, kw, out))

        def prefill_(*a, _fn=self.saved[0], **kw):
            out = _fn(*a, **kw)
            record("prefill causal" if kw.get("causal", True)
                   else "prefill full", a, kw, out)
            return out

        def decode_(*a, _fn=self.saved[1], **kw):
            out = _fn(*a, **kw)
            record("decode self" if attention_bias(a, kw, None) is not None
                   else "decode memory", a, kw, out)
            return out

        ops.prefill_attention, ops.decode_attention = prefill_, decode_
        return self

    def __exit__(self, *exc):
        self.ops.prefill_attention, self.ops.decode_attention = self.saved
        return False


_ZEROS = object()


def attention_bias(a, kw, missing=_ZEROS):
    """A recorded ``ops.decode_attention`` call's bias; a memory's (no
    bias) as zeros, or ``missing`` where that is given."""
    import torch

    bias = a[3] if len(a) > 3 else kw.get("bias")
    if bias is None and missing is _ZEROS:
        bias = torch.zeros((a[0].shape[0], a[1].shape[2]),
                           dtype=torch.float32, device=a[0].device)
    return missing if bias is None else bias


def attention_plain(kind, a, kw):
    """The plain version's output of a recorded attention call."""
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod

    if kind.startswith("prefill"):
        return pre_mod.flash_prefill_plain(a[0], a[1], a[2],
                                           kw.get("causal", True))
    return dec_mod.flash_decode_plain(a[0], a[1], a[2], attention_bias(a, kw))


class moe_routing:
    """Records each ``moe.route`` call's (gates, experts, probs) in order;
    given ``replay`` (such a record), returns its entries in place of the
    calls' own."""

    def __init__(self, replay=None):
        self.replay, self.calls = replay, []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.saved = moe_mod, moe_mod.route

        def route(*a, **kw):
            self.calls.append(self.saved(*a, **kw))
            return self.calls[-1] if self.replay is None else \
                self.replay[len(self.calls) - 1]

        moe_mod.route = route
        return self.calls

    def __exit__(self, *exc):
        self.mod.route = self.saved
        return False


def run_archs(args, device, kernels, kernel_policy=None, *, held=None,
              reduced=False, requests=ARCH_REQUESTS,
              prompt=(ARCH_PROMPT_MIN, ARCH_PROMPT_MAX), new=ARCH_NEW,
              check_seq=ARCH_CHECK_SEQ, archs=ARCHS_M,
              epiql=(EPIQL_POP, EPIQL_DAYS)) -> tuple:
    """Phase M: ``serve_batch`` of each architecture of ``archs`` at its
    published config (``reduced`` serves ``configs.reduced``: the CPU's
    rehearsal), parameters drawn from ``--seed``, bf16 compute, after EpiQL
    at ``epiql`` (population, days). For each: ``requests`` prompts of
    ``prompt`` tokens (from ``--seed``, the same for every architecture:
    within the smallest vocabulary), ``new`` greedy tokens each; the calls
    by route against ``ARCH_ROUTES`` (and ``attention_calls``), the launches,
    no plain attention call; (a) at the first and last layer of each
    kernel route (causal and non-causal prefill, self and memory decode)
    the kernel's output on the model's own q, k, v against its plain
    version (``BF16_TOL``), each route's shape through the checked builds
    (``flash_prefill.out_of_bounds``, ``flash_decode.out_of_bounds``); (b)
    the prefill's logits on the kernel path against the plain path's,
    within ``LM_PATH_TOL`` or twice the spread one bf16 ulp of attention
    noise gives on the same model, an MoE model's routing replayed; (c)
    for ``ARCH_F32_CHECK``, at float32 compute,
    ``prefill`` and a ``decode_step`` against ``forward`` over ``check_seq``
    tokens (``LM_PREFILL_TOL``); the times of a warm ``serve_batch``; each
    kernel at the architecture's shapes beside its plain version and SDPA
    (random operands, the error held too); with ``--profile`` a prefill's
    and a step's device time by kind. An architecture that fails is
    logged and the next one runs; the phase then fails. Parameters are
    drawn on the host (``init_model(cfg, seed, device='cpu')``, the values
    ``init_model`` puts on the card), the next ones while this one is
    served (``DRAW_WORKERS`` at once where the host has room).
    ``held``: the bytes phase I found earlier phases holding; M starts with
    no more. Returns (launches, the numbers)."""
    import concurrent.futures
    import dataclasses
    import traceback

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.config import DEFAULT_POLICY, KernelPolicy
    from repro_torch.engine import QueryEngine
    from repro_torch.examples import epiql_contact_sim
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import fused_draw as fd_mod
    from repro_torch.kernels import ops, ref, threefry
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, forward, init_model, prefill
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import attention_calls
    from repro_torch.models import ssm as ssm_mod

    on_card = device.type == "cuda"
    policy = kernel_policy or DEFAULT_POLICY
    e2e = {"archs": {}}
    launches = {k: 0 for k in kernels}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    failures = []
    gc_cuda(on_card)
    if on_card:
        before = torch.cuda.memory_allocated(device)
        # cuBLAS keeps a workspace for each (handle, stream) that ran a
        # product, through the caching allocator: earlier phases' threads
        # and streams left theirs
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is None:
            log("[M] this torch cannot release cuBLAS's workspaces")
        else:
            clear()
        gc_cuda(on_card)
        now = torch.cuda.memory_allocated(device)
        log(f"[M] earlier phases hold {now / 2**30:.2f} GiB at M's start "
            f"({before / 2**30:.2f} GiB before cuBLAS's workspaces were "
            "released)" + ("" if held is None else
                           f"; phase I found {held / 2**30:.2f} GiB"))
        if held is not None and now > held:
            failures.append(f"held: {now} bytes at M's start, {held} at I's")
            log(f"[M] FAILED: earlier phases hold {now - held} bytes more "
                f"than at I's start; live CUDA tensors by shape: "
                f"{cuda_census()}")
        e2e["held_bytes"] = now
    # the CLI, in a child process while the first architectures run
    cli = None
    if on_card and not reduced:
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
             "--full", "--arch", "gemma3_1b"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parent / "src")))

    # -- EpiQL: the contact join's index once, a Poisson draw a day -----------
    pop, days = epiql
    t0 = time.perf_counter()
    reset_counts(kernels)
    epi = epiql_contact_sim.simulate(pop, days=days, device=device)
    got = launch_counts(kernels)
    ks = [k for _, k, _, _ in epi["days"]]
    log(f"[M.epiql] population {pop}: contact join {epi['join_size']:,} "
        f"tuples (never materialized), draw route {epi['route']}, E[k] "
        f"{epi['expected_k']:.1f} (sd {epi['sd_k']:.1f}); contacts a day "
        f"{ks}; new infections {[n for _, _, n, _ in epi['days']]}; ms a day "
        f"{[round(ms, 3) for _, _, _, ms in epi['days']]}; attack rate "
        f"{epi['attack_rate']:.4f}; launches "
        f"{ {k: v for k, v in got.items() if v} }; "
        f"{time.perf_counter() - t0:.1f} s")
    if on_card and epi["route"] == "fused":
        assert got["fused_draw"] == days, got
    for k, v in got.items():
        launches[k] += v
    # Its days by distribution: the count within Z_LIMIT sd of E[k] where
    # the float32 kernel draw resolves a cell (its arrival sum's ulp at the
    # total mass Lam under the smallest cell rate lam); where it does not,
    # arrivals a ulp apart merge into one cell and the count falls short:
    # the reference's float32 draw, whose routing (by arena size) the port
    # keeps (ROADMAP C). Two days drawn again through the per-node route
    # (float64 arrivals) hold the rule at any size.
    db, q = epiql_contact_sim.build_population(pop, 75, 6, 0, device=device)
    plan = QueryEngine(db, device=device).compile(q)
    dp = plan.draw_params
    coarse = None
    if dp is not None:
        R = dp["w32"].shape[0]
        ulp = float(np.spacing(np.float32(dp["massE"][R].item())))
        lam_min = float(dp["lam"][dp["w32"] > 0].min())
        coarse = (ulp, lam_min) if ulp > lam_min else None
    E, sd = epi["expected_k"], epi["sd_k"]
    z = [(k - E) / sd for k in ks]
    if coarse is None:
        assert all(abs(x) <= Z_LIMIT for x in z), (z, epi)
    t0 = time.perf_counter()
    pernode = [int(plan.sample(threefry.fold_in(threefry.key(42), d),
                               rep=plan.rep_default).count) for d in range(2)]
    sync()
    pernode_ms = (time.perf_counter() - t0) * 1e3 / 2
    zp = [(k - E) / sd for k in pernode]
    log(f"[check] M.epiql daily contacts against E[k]: "
        f"{[round(x, 2) for x in z]} sd on the {epi['route']} route"
        + ("" if coarse is None else
           f" (mean {100 * (sum(ks) / len(ks) / E - 1):.2f}%: the float32 "
           f"draw's resolution, ulp(Lam) {coarse[0]:g} over the smallest "
           f"cell rate {coarse[1]:.4g}, merges arrivals; held below to its "
           f"plain pipeline, not to E[k])")
        + f"; days 0-1 through the per-node route {pernode} "
        f"({[round(x, 2) for x in zp]} sd, {pernode_ms:.1f} ms a day; held "
        f"within {Z_LIMIT} sd)")
    assert all(abs(x) <= Z_LIMIT for x in zp), (zp, pernode)
    # The route the example takes, held at any size, on day 0 again: its
    # rows, positions and count bit for bit against the route's plain
    # version on the card's own tables, and its count against the port's
    # plain pipeline on the CPU under the same key (its own tables, built
    # on the CPU) within EPIQL_ROUTE_TOL x E[k]. Tables of the two devices
    # that round apart by an ulp move arrivals between neighbouring cells
    # where the float32 draw is coarse: the rows the card drew that the
    # CPU did not are logged, not held
    key0 = threefry.fold_in(threefry.key(42), 0)
    got0 = plan.sample(key0)
    k0 = int(got0.count)
    assert k0 == ks[0], (k0, ks)
    plain0 = "no kernel on the per-node route"
    if plan.route == "fused":
        pack = plan.shred.packed
        rows, pos, cnt, ovf = fd_mod.fused_draw_plain(
            pack.arena, key0, dp, layout=pack.layout, method=plan.method,
            cap=plan.default_capacity(), acap=plan.arrival_capacity())
        assert int(cnt) == k0 and not bool(ovf), (int(cnt), k0)
        assert torch.equal(got0.positions[:k0], pos[:k0].long()), k0
        plain0 = f"rows and positions equal its plain version's ({int(cnt)})"
        del rows, pos
    cdb, cq = epiql_contact_sim.build_population(pop, 75, 6, 0, device="cpu")
    # the CPU takes the kernel routes' plain versions only where preferred
    cplan = QueryEngine(cdb, device="cpu", kernel_policy=KernelPolicy(
        prefer=plan.route != "pernode")).compile(cq)
    assert cplan.route == plan.route, (cplan.route, plan.route)
    want0 = cplan.sample(key0)
    kc = int(want0.count)
    cdp = cplan.draw_params
    table_diff = {} if dp is None or cdp is None else {
        name: float((dp[name].double().cpu() - cdp[name].double()).abs()
                    .max()) for name in ("massE", "lam")}

    def pairs(s, k):
        return (s.columns["per1"][:k].long().cpu() * pop
                + s.columns["per2"][:k].long().cpu())

    only_card = int((~torch.isin(pairs(got0, k0), pairs(want0, kc))).sum())
    bound = EPIQL_ROUTE_TOL * E
    log(f"[check] M.epiql day 0 on the {plan.route} route: {plain0}; "
        f"{k0} contacts against {kc} on the CPU's plain pipeline (held "
        f"within {EPIQL_ROUTE_TOL:g} x E[k] = {bound:.1f}); {only_card} rows "
        f"drawn on the card alone, the tables' largest differences "
        f"{table_diff} (not held)")
    assert abs(k0 - kc) <= bound, (k0, kc)
    del db, plan, dp, cdb, cplan, cdp, got0, want0
    e2e["epiql"] = dict(epi, z=z, pernode=pernode, pernode_z=zp,
                        pernode_ms=pernode_ms,
                        float32_resolution=coarse, day0_cpu=kc,
                        day0_card_only=only_card, day0_tables=table_diff)

    # the same prompts for every architecture, within the smallest vocabulary
    cfgs = {a: configs.get_config(a) for a in archs}
    if reduced:
        cfgs = {a: configs.reduced(c) for a, c in cfgs.items()}
    vocab = min(c.vocab for c in cfgs.values())
    rng = np.random.default_rng(args.seed + 29)
    lens = rng.integers(prompt[0], prompt[1] + 1, requests)
    prompts = [rng.integers(1, vocab, n).tolist() for n in lens]
    check_toks = rng.integers(1, vocab, (2, check_seq))
    S = int(max(lens))
    B = len(prompts)
    total = S + new + 1
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.as_tensor(p)
    toks = toks.to(device)

    def new_requests():
        return [serve.Request(prompt=list(p), max_new=new) for p in prompts]

    plain_targets = [(dec_mod, "flash_decode_plain"),
                     (pre_mod, "flash_prefill_plain"),
                     (ref, "flash_decode_ref"), (ref, "flash_prefill_ref")]
    route_targets = [(attn_mod, "blockwise_attention")]

    routes = attention_routes

    def draw_on_host(cfg):
        t = time.perf_counter()
        m = init_model(cfg, args.seed, device="cpu", policy=policy)
        return m, time.perf_counter() - t

    bias_of, plain_of = attention_bias, attention_plain

    def serve_arch(arch, cfg, model, out, draw_s, move_s):
        """One architecture of phase M on ``model``: the main path,
        the checks, the times; its numbers go into ``out``."""
        marks = [("start", time.perf_counter())]
        n_params = sum(p.numel() for p in model.parameters())
        want = attention_calls(cfg)
        if not reduced:
            assert want == ARCH_ROUTES[arch], (arch, want)
        log(f"[M] {cfg.name}: {cfg.n_layers} layers {cfg.pattern[:6]}"
            f"{'...' if len(cfg.pattern) > 6 else ''} x {cfg.repeats}"
            f"{f' + {cfg.enc_layers} encoder' if cfg.has_encoder else ''}"
            f", d_model {cfg.d_model}, H {cfg.n_heads}, KV "
            f"{cfg.n_kv_heads}, head dim {cfg.hd}, vocab {cfg.vocab}; "
            f"{n_params:,} {cfg.param_dtype} parameters (seed "
            f"{args.seed}) drawn on the host in {draw_s:.1f} s (waited "
            f"{out['draw_wait_s']:.1f} s for it), moved in {move_s:.1f} s; "
            f"{cfg.compute_dtype} compute")
        out.update(params=n_params, draw_s=draw_s, move_s=move_s)

        # -- the main path: serve_batch ------------------------------------
        reset_counts(kernels)
        if on_card:
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        stats = {}
        with counting_calls(plain_targets) as plain_calls, \
                counting_calls(route_targets) as blockwise, \
                routes() as seen:
            t0 = time.perf_counter()
            done = serve.serve_batch(arch, new_requests(), seed=args.seed,
                                     reduced=reduced, params=model,
                                     stats=stats)
            sync()
            cold_s = time.perf_counter() - t0
        got = launch_counts(kernels)
        calls = (seen.n.get("prefill causal", 0),
                 seen.n.get("prefill full", 0),
                 blockwise["attention.blockwise_attention"],
                 (seen.n.get("decode self", 0)
                  + seen.n.get("decode memory", 0)) // new)
        log(f"[M] {arch} launches "
            f"{ {k: v for k, v in got.items() if v} }; calls by route "
            f"{seen.n}, blockwise {calls[2]}; plain attention calls "
            f"{plain_calls}; instances {window_tiles(kernels)}")
        assert calls == want, (arch, calls, want)
        assert sum(seen.n.get(k, 0) for k in ("decode self",
                                              "decode memory")) \
            == want[3] * new, (arch, seen.n)
        if on_card:
            assert got["flash_prefill"] == want[0] + want[1], got
            assert got["flash_decode"] == want[3] * new, got
            assert all(v == 0 for k, v in got.items()
                       if k not in ("flash_prefill", "flash_decode")), got
            assert all(v == 0 for v in plain_calls.values()), plain_calls
            out["peak_bytes"] = int(
                torch.cuda.max_memory_allocated(device)) - before
            out["model_bytes"] = before
        for k, v in got.items():
            launches[k] += v
        assert all(len(r.out) == new and
                   all(0 <= t < cfg.vocab for t in r.out) for r in done)
        log(f"[M] {arch} served {B} requests (prompts "
            f"{sorted(int(n) for n in lens)} tokens, padded to {S}; cache "
            f"{stats['cache_len']}), {new} tokens each, cold in "
            f"{cold_s:.2f} s; request 0 -> {done[0].out[:8]}")
        out.update(cold_s=cold_s, launches=got, routes=calls)

        marks.append(("main path", time.perf_counter()))
        # -- (a) and (b): an architecture without attention layers (rwkv6)
        # has no kernel on its path, and its two paths are one computation
        if not any(want):
            log(f"[check] M {arch}: no attention layer, no kernel route: (a) "
                "and (b) compare nothing")
        else:
            # -- (a) each kernel route's first and last layer; checked builds
            with torch.no_grad(), routes(keep=True) as rec:
                mem = serve.batch_memory(model, B)
                with routing() as routed_k:
                    logits_k, cache = prefill(model, toks, total, mem)
                decode_step(model, cache, toks[:, -1:], S)
            sync()
            errs = {}
            for kind, ends in sorted(rec.calls.items()):
                for end, (a, kw, got_out) in zip(("first", "last"), ends):
                    err = close(got_out, plain_of(kind, a, kw), BF16_TOL)
                    name = f"flash_{kind.split()[0]}"
                    errs[name] = max(errs.get(name, 0.0), err)
                    log(f"[check] M {arch} {kind} {end} layer on the model's "
                        f"own q {tuple(a[0].shape)}, k {tuple(a[1].shape)}: "
                        f"kernel vs plain max_abs_err {err:.3g} (rtol, atol "
                        f"{BF16_TOL})")
                if on_card:
                    # the checked build at the tile the main path resolved
                    # (ops' ladder, tile_for, at this S), not the builtin
                    a, kw, _ = ends[0]
                    t0 = time.perf_counter()
                    if kind.startswith("prefill"):
                        tq, tk = autotune.tile_for(
                            "flash_prefill", a[0].shape[2], model.policy,
                            device)
                        tile = (kw.get("block_q") or tq,
                                kw.get("block_k") or tk)
                        oob = pre_mod.out_of_bounds(
                            a[0], a[1], a[2], kw.get("causal", True), *tile)
                        lib = "flash_prefill_tc_checked"
                    else:
                        tile = (kw.get("block_s") or autotune.tile_for(
                            "flash_decode", a[1].shape[2], model.policy,
                            device),)
                        oob = dec_mod.out_of_bounds(a[0], a[1], a[2],
                                                    bias_of(a, kw), *tile)
                        lib = "flash_decode_checked"
                    oob_ms = (time.perf_counter() - t0) * 1e3
                    err = close(oob["out"], plain_of(kind, a, kw), BF16_TOL)
                    checked[lib].append(dict(
                        arch=arch, kind=kind, count=oob["count"],
                        ms=oob_ms, err=err, tile=list(tile),
                        shape=[tuple(a[0].shape), tuple(a[1].shape)]))
                    log(f"[check] M {arch} {lib} at the {kind} shape q "
                        f"{tuple(a[0].shape)}, k {tuple(a[1].shape)}, "
                        f"{str(a[0].dtype)[6:]}, tile {tile}: "
                        f"{oob['count']} accesses outside the operands "
                        f"{oob['loads'][:4]}; its output vs plain "
                        f"{err:.3g}")
                    assert oob["count"] == 0, (arch, kind, oob)
            assert (rec.n.get("prefill causal", 0),
                    rec.n.get("prefill full", 0)) == want[:2], rec.n
            del rec, cache, mem
            out["attention_errs"] = errs

            # -- (b) the kernel path's prefill logits against the plain path's.
            # An MoE layer's top-k is not continuous in its input: an ulp of
            # attention noise flips a near-tie between two experts. For an MoE
            # model the bound holds with the kernel path's routing replayed in
            # the plain path; the unpinned error and the flips are reported.
            # The bound: LM_PATH_TOL, or twice the spread that one bf16 ulp of
            # noise on a random half of every flash_prefill output gives on the
            # plain path (the derivation of LM_PATH_TOL at smollm-135m's
            # widths), where that is larger: the logits' scale and the depth
            # set it.
            model.policy = KernelPolicy(enabled=False)
            try:
                with torch.no_grad():
                    mem = serve.batch_memory(model, B)
                    with routing() as routed_p:
                        logits_p, _ = prefill(model, toks, total, mem)
                    replay = routed_k or None
                    if routed_k:
                        with routing(replay=replay):
                            logits_pin, _ = prefill(model, toks, total, mem)
                    saved = ops.prefill_attention
                    ops.prefill_attention = ulp_noise(saved, args.seed + 31)
                    try:
                        with routing(replay=replay):
                            logits_n, _ = prefill(model, toks, total, mem)
                    finally:
                        ops.prefill_attention = saved
                    del mem
            finally:
                model.policy = policy
            spread = float((logits_n - logits_p).abs().max())
            tol = max(LM_PATH_TOL, 2 * spread)
            out.update(bf16_noise_spread=spread, bf16_path_bound=tol)
            del logits_n
            err_path = float((logits_k - logits_p).abs().max())
            agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)
                           ).float().mean())
            sd = float(logits_p.float().std())
            out.update(bf16_path_err=err_path, bf16_path_argmax_agree=agree,
                       logits_sd=sd)
            pinned = ""
            if routed_k:
                flips = sum(int((ek.sort(-1).values != ep.sort(-1).values)
                                .any(-1).sum())
                            for (_, ek, _), (_, ep, _)
                            in zip(routed_k, routed_p))
                err_pin = float((logits_k - logits_pin).abs().max())
                out.update(bf16_path_err_pinned=err_pin, routing_flips=flips)
                pinned = (f"; {flips} of {len(routed_k) * B * S} "
                          "token-layer routings chose other experts on the "
                          "plain path; with the kernel path's routing "
                          f"replayed {err_pin:.4g}")
                del logits_pin
            log(f"[check] M {arch} bf16 prefill logits, kernel path vs plain "
                f"path (B {B}, S {S}): max_abs_err {err_path:.4g}{pinned} "
                f"(bound {tol:.4g}: LM_PATH_TOL {LM_PATH_TOL}, one ulp of "
                f"attention noise spreads {spread:.4g}; logits' sd {sd:.3f}), "
                f"argmax agree on {agree:.3f} of the rows")
            assert out.get("bf16_path_err_pinned", err_path) <= tol, \
                (arch, out)
            del logits_k, logits_p, routed_k, routed_p

        marks.append(("(a), (b)", time.perf_counter()))
        # -- (c) float32: prefill and a decode step against forward ---------
        if arch in ARCH_F32_CHECK:
            model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
            gen = torch.Generator(device=device).manual_seed(args.seed)
            frames = (torch.randn((2, cfg.n_memory_tokens,
                                   cfg.enc_d_model), generator=gen,
                                  device=device)
                      if cfg.has_encoder else None)
            t2 = torch.as_tensor(check_toks, device=device)
            Sc = t2.shape[1]
            try:
                with torch.no_grad():
                    mem = serve.batch_memory(model, 2, frames)
                    lp, c32 = prefill(model, t2, Sc + 2, mem)
                    lf, _ = forward(model, t2, mem)
                    err_pre = float((lp[:, 0] - lf[:, -1]).abs().max())
                    nxt = lp[:, -1].argmax(-1, keepdim=True)
                    ld, _ = decode_step(model, c32, nxt, Sc)
                    del lf, c32
                    lf2, _ = forward(model, torch.cat([t2, nxt], dim=1),
                                     mem)
                    err_dec = float((ld[:, 0] - lf2[:, -1]).abs().max())
                    del lp, ld, lf2, mem
            finally:
                model.cfg = cfg
            log(f"[check] M {arch} float32 at full width and depth, B 2, "
                f"S {Sc}{' (random frames)' if frames is not None else ''}"
                f": prefill's last logits vs forward's max_abs_err "
                f"{err_pre:.3g}; a decode_step at {Sc} vs forward over "
                f"{Sc + 1} tokens {err_dec:.3g} (bound {LM_PREFILL_TOL})")
            assert err_pre <= LM_PREFILL_TOL and \
                err_dec <= LM_PREFILL_TOL, (arch, err_pre, err_dec)
            out.update(float32_prefill_err=err_pre,
                       float32_decode_err=err_dec)
            sync()

        marks.append(("(c)", time.perf_counter()))
        # -- times: a warm serve_batch -----------------------------------
        stats = {}
        t0 = time.perf_counter()
        serve.serve_batch(arch, new_requests(), params=model, stats=stats)
        sync()
        wall_s = time.perf_counter() - t0
        dec = stats["decode_ms"]
        out.update(wall_s=wall_s, prefill_ms=stats["prefill_ms"],
                   decode_step_mean_ms=sum(dec) / len(dec),
                   decode_step_ms=dec, tokens_per_s=B * new / wall_s)
        log(f"[time] M {arch} serve_batch (warm): {wall_s * 1e3:.2f} ms "
            f"for {B * new} new tokens ({out['tokens_per_s']:.1f} "
            f"tokens/s); prefill of {B} x {S} {stats['prefill_ms']:.3f} "
            f"ms; decode step mean {out['decode_step_mean_ms']:.3f} ms "
            f"(min {min(dec):.3f}, max {max(dec):.3f})"
            + (f"; peak device memory of the cold run "
               f"{out['peak_bytes'] / 2**30:.2f} GiB over the "
               f"{out['model_bytes'] / 2**30:.2f} GiB the model and "
               "earlier phases hold" if on_card else ""))

        # -- the kernels at this architecture's shapes, beside SDPA --------
        out["kernel_times"] = arch_kernel_times(
            args, device, cfg, B, S, total, want, reduced)

        marks.append(("times", time.perf_counter()))
        # -- --profile: a prefill's and a step's device time by kind -------
        if on_card and args.profile:
            kinds = {"blockwise_attention": "blockwise",
                     "moe_ffn": "moe_dispatch/",
                     "_ssd_chunked": "scans", "_wkv6_scan": "scans"}
            with torch.no_grad(), ranged(
                    [(attn_mod, "blockwise_attention",
                      "blockwise_attention"),
                     (moe_mod, "moe_ffn", "moe_ffn"),
                     (ssm_mod, "_ssd_chunked", "_ssd_chunked"),
                     (ssm_mod, "_wkv6_scan", "_wkv6_scan")]):
                mem = serve.batch_memory(model, B)
                _, cache = prefill(model, toks, total, mem)
                sync()
                nxt = toks[:, -1:]
                windows = {
                    "prefill": lambda: prefill(model, toks, total, mem),
                    "decode step": lambda: decode_step(model, cache, nxt,
                                                       S)}
                for label, fn in windows.items():
                    wall = wall_ms(fn, device)
                    events = profiled(fn, 1).events()
                    split = profile_by_kind(events, kinds)
                    busy = sum(split.values())
                    prof = dict(split, busy_ms=busy, wall_ms=wall,
                                idle_share=1 - busy / wall)
                    out[f"profile_{label}"] = prof
                    log(f"[profile] M {arch} {label}: device busy "
                        f"{busy:.3f} ms of {wall:.3f} ms warm wall (idle "
                        f"share {prof['idle_share']:.3f}): "
                        + ", ".join(f"{k} {v:.3f}"
                                    for k, v in split.items()))
                del cache, mem
        marks.append(("profile", time.perf_counter()))
        out["seconds"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
        log(f"[M] {arch} in {marks[-1][1] - marks[0][1]:.1f} s: "
            + ", ".join(f"{k} {v:.1f}" for k, v in out["seconds"].items()))

    routing = moe_routing

    checked = {"flash_prefill_tc_checked": [], "flash_decode_checked": []}
    # Draws on the host, up to DRAW_WORKERS at once while the host has room
    # for another model (MemAvailable less the models in flight, less
    # HOST_RESERVE); the next model to serve is drawn in any case.
    sizes = {a: 4 * sum(p.numel() for p in init_model(
        c, device="meta").parameters()) for a, c in cfgs.items()}
    pool = concurrent.futures.ThreadPoolExecutor(DRAW_WORKERS)
    drawing, queue = {}, list(archs)

    def refill(need=None):
        while queue and sum(not f.done() for f in drawing.values()) \
                < DRAW_WORKERS:
            flight = sum(sizes[a] for a, f in drawing.items()
                         if not f.done())
            room = host_available()
            if queue[0] != need and (room is None or room - flight
                                     < sizes[queue[0]] + HOST_RESERVE):
                return
            drawing[queue[0]] = pool.submit(draw_on_host, cfgs[queue[0]])
            queue.pop(0)

    room = host_available()
    log(f"[M] the models' float32 parameters {sum(sizes.values()) / 2**30:.1f}"
        f" GiB; the host has "
        + ("an unknown amount" if room is None else f"{room / 2**30:.1f} GiB")
        + f" available; {DRAW_WORKERS} draws at most at once")
    try:
        for i, arch in enumerate(archs):
            cfg = cfgs[arch]
            out = {}
            t0 = time.perf_counter()
            refill(need=arch)
            model, draw_s = drawing.pop(arch).result()
            out["draw_wait_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            model = model.to(device)
            sync()
            move_s = time.perf_counter() - t0
            refill()
            try:
                serve_arch(arch, cfg, model, out, draw_s, move_s)
                e2e["archs"][arch] = out
            except Exception:  # the next architecture still runs
                failures.append(f"{arch}: {traceback.format_exc()}")
                log(f"[M] {arch} FAILED:\n{failures[-1]}")
            finally:
                del model
                gc_cuda(on_card)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    hwm = proc_bytes("/proc/self/status", "VmHWM")
    if hwm is not None:
        log(f"[M] the process's peak resident memory {hwm / 2**30:.1f} GiB")
        e2e["host_peak_bytes"] = hwm
    if cli is not None:
        text, _ = cli.communicate(timeout=600)
        for line in text.splitlines()[-8:]:
            log(f"[M.cli] {line}")
        log(f"[M.cli] python -m repro_torch.launch.serve --mode lm --full "
            f"--arch gemma3_1b exited {cli.returncode}")
        assert cli.returncode == 0, text[-2000:]
        e2e["cli_rc"] = cli.returncode
    e2e["checked"] = checked
    assert not failures, "phase M failed for " + "; ".join(
        f.split(":")[0] for f in failures)
    return launches, e2e


# Phase N: the reduced config (``configs.reduced``: head dim 16, float32,
# two repeats of each block type, vocabulary 256) of each of the ten
# architectures, the reference's default for ``serve`` and ``train``, on
# the float32 attention kernels' D 16 instances. llama3-405b and
# llama4-scout run on the card only here.
ARCHS_N = ("smollm_135m", "starcoder2_7b", "gemma3_1b", "llama3_405b",
           "llama32_vision_11b", "llama4_scout_17b_16e", "olmoe_1b_7b",
           "whisper_small", "rwkv6_7b", "zamba2_1p2b")
# each reduced config's attention calls (``attention_calls``): (causal,
# non-causal, blockwise) a prefill, decodes a step
ARCH_ROUTES_N = {"smollm_135m": (2, 0, 0, 2), "starcoder2_7b": (2, 0, 0, 2),
                 "gemma3_1b": (2, 0, 2, 4), "llama3_405b": (2, 0, 0, 2),
                 "llama32_vision_11b": (4, 0, 2, 6),
                 "llama4_scout_17b_16e": (2, 0, 0, 2),
                 "olmoe_1b_7b": (2, 0, 0, 2), "whisper_small": (2, 2, 2, 4),
                 "rwkv6_7b": (0, 0, 0, 0), "zamba2_1p2b": (2, 0, 0, 2)}
# phase N's requests: prompts of 8-24 tokens, greedy tokens each; the
# reduced train's steps (``launch.train``'s defaults otherwise)
REDUCED_REQUESTS, REDUCED_PROMPT_MIN, REDUCED_PROMPT_MAX = 2, 8, 24
REDUCED_NEW, REDUCED_TRAIN_STEPS = 8, 3


def run_reduced(args, device, kernels, kernel_policy=None, *,
                train_steps=REDUCED_TRAIN_STEPS) -> tuple:
    """Phase N: ``serve_batch`` of each architecture's reduced config
    (``ARCHS_N``), parameters drawn from ``--seed`` on the card, float32:
    ``REDUCED_REQUESTS`` prompts of ``REDUCED_PROMPT_MIN`` to
    ``REDUCED_PROMPT_MAX`` tokens, ``REDUCED_NEW`` greedy tokens each; its
    calls by route against ``ARCH_ROUTES_N``, one ``flash_prefill`` launch a
    prefill call and one ``flash_decode`` a decode call, no plain attention
    call. Checks: the prefill's logits and every decode step's, teacher-
    forced on the kernel path's tokens, on the kernel path against the
    plain path (``KernelPolicy(enabled=False)``, an MoE model's routing
    replayed) within ``LM_PREFILL_TOL``; each route's first call through
    the float32 checked builds (``flash_prefill.out_of_bounds``,
    ``flash_decode.out_of_bounds``) at the tile the main path resolved,
    none outside the operands; each kernel at the architecture's shapes
    beside its plain version and SDPA. Then ``python -m
    repro_torch.launch.serve --mode lm`` with its defaults in a child
    process, and ``launch.train.main`` on the reduced smollm-135m for
    ``train_steps`` steps (one ``flash_prefill`` a layer a step) and its
    gradients on the kernel route against the plain route's
    (``TRAIN_GRAD_TOL``). An architecture that fails is logged and the next
    one runs; the phase then fails. Returns (launches, the numbers)."""
    import shutil
    import tempfile
    import traceback

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.config import DEFAULT_POLICY, KernelPolicy
    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, init_model, loss_fn, prefill
    from repro_torch.models.transformer import attention_calls

    on_card = device.type == "cuda"
    policy = kernel_policy or DEFAULT_POLICY
    t_phase = time.perf_counter()
    e2e = {"archs": {}}
    launches = {k: 0 for k in kernels}
    checked = {"flash_prefill_checked": [], "flash_decode_checked": []}
    failures = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gc_cuda(on_card)
    # the CLI with its defaults (the reduced smollm-135m), in a child
    # process while the architectures run
    cli = None
    if on_card:
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
             "lm"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parent / "src")))

    rng = np.random.default_rng(args.seed + 37)
    lens = rng.integers(REDUCED_PROMPT_MIN, REDUCED_PROMPT_MAX + 1,
                        REDUCED_REQUESTS)
    vocab = min(configs.reduced(configs.get_config(a)).vocab
                for a in ARCHS_N)
    prompts = [rng.integers(1, vocab, n).tolist() for n in lens]
    B, S, new = len(prompts), int(max(lens)), REDUCED_NEW
    total = S + new + 1
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, pr in enumerate(prompts):
        toks[i, :len(pr)] = torch.as_tensor(pr)
    toks = toks.to(device)
    plain_targets = [(dec_mod, "flash_decode_plain"),
                     (pre_mod, "flash_prefill_plain"),
                     (ref, "flash_decode_ref"), (ref, "flash_prefill_ref")]
    bias_of, plain_of = attention_bias, attention_plain

    def path(model, feed=None, replay=None):
        """The prefill's logits and ``new`` decode steps', each step fed
        the last one's argmax or ``feed``'s token; the tokens fed, the MoE
        routing (``replay``'s where given) and each route's first call."""
        out, fed = [], []
        with torch.no_grad(), moe_routing(replay) as routed, \
                attention_routes(keep=True) as seen:
            mem = serve.batch_memory(model, B)
            logits, cache = prefill(model, toks, total, mem)
            out.append(logits)
            for t in range(new):
                fed.append(logits[:, -1].argmax(-1, keepdim=True)
                           if feed is None else feed[t])
                logits, cache = decode_step(model, cache, fed[-1], S + t)
                out.append(logits)
        sync()
        return out, fed, routed, {k: v[0][:2] for k, v in seen.calls.items()}

    def one(arch):
        t_arch = time.perf_counter()
        cfg = configs.reduced(configs.get_config(arch))
        want = attention_calls(cfg)
        assert want == ARCH_ROUTES_N[arch], (arch, want)
        model = init_model(cfg, args.seed, device=device, policy=policy)
        out = {"params": sum(p.numel() for p in model.parameters())}
        # -- the main path: serve_batch ------------------------------------
        reset_counts(kernels)
        stats = {}
        with counting_calls(plain_targets) as plain_calls, \
                counting_calls([(attn_mod, "blockwise_attention")]) as \
                blockwise, attention_routes() as seen:
            done = serve.serve_batch(
                arch, [serve.Request(prompt=list(pr), max_new=new)
                       for pr in prompts], seed=args.seed, reduced=True,
                params=model, stats=stats)
            sync()
        got = launch_counts(kernels)
        calls = (seen.n.get("prefill causal", 0),
                 seen.n.get("prefill full", 0),
                 blockwise["attention.blockwise_attention"],
                 (seen.n.get("decode self", 0)
                  + seen.n.get("decode memory", 0)) // new)
        log(f"[N] {cfg.name}: {cfg.n_layers} layers {cfg.pattern}, "
            f"d_model {cfg.d_model}, H {cfg.n_heads}, KV {cfg.n_kv_heads}, "
            f"head dim {cfg.hd}, {out['params']:,} parameters; launches "
            f"{ {k: v for k, v in got.items() if v} }; calls by route "
            f"{seen.n}, blockwise {calls[2]}; plain attention calls "
            f"{plain_calls}; instances {window_tiles(kernels)}; request 0 "
            f"-> {done[0].out}")
        assert calls == want and sum(
            seen.n.get(k, 0) for k in ("decode self", "decode memory")) \
            == want[3] * new, (arch, seen.n, calls, want)
        assert all(len(r.out) == new and
                   all(0 <= t < cfg.vocab for t in r.out) for r in done)
        if on_card:
            assert got["flash_prefill"] == want[0] + want[1], got
            assert got["flash_decode"] == want[3] * new, got
            assert all(v == 0 for k, v in got.items()
                       if k not in ("flash_prefill", "flash_decode")), got
            assert all(v == 0 for v in plain_calls.values()), plain_calls
        for k, v in got.items():
            launches[k] += v
        out.update(launches=got, prefill_ms=stats["prefill_ms"],
                   decode_step_mean_ms=sum(stats["decode_ms"])
                   / len(stats["decode_ms"]))
        # -- the kernel path against the plain path, teacher-forced --------
        logits_k, fed, routed, firsts = path(model)
        model.policy = KernelPolicy(enabled=False)
        try:
            logits_p, _, _, _ = path(model, fed, routed or None)
        finally:
            model.policy = policy
        errs = [float((a - b).abs().max()) for a, b in zip(logits_k,
                                                           logits_p)]
        log(f"[check] N {arch} float32 logits, kernel path vs plain path "
            f"(B {B}, S {S}, {new} steps fed the kernel path's tokens"
            f"{', MoE routing replayed' if routed else ''}): prefill "
            f"max_abs_err {errs[0]:.3g}, decode steps {max(errs[1:]):.3g} "
            f"(bound {LM_PREFILL_TOL})")
        assert max(errs) <= LM_PREFILL_TOL, (arch, errs)
        out.update(prefill_err=errs[0], decode_err=max(errs[1:]))
        # -- each route's first call through the checked builds -----------
        for kind, (a, kw) in sorted(firsts.items() if on_card else ()):
            want_out = plain_of(kind, a, kw)
            t0 = time.perf_counter()
            if kind.startswith("prefill"):
                tile = autotune.tile_for("flash_prefill", a[0].shape[2],
                                         model.policy, device)
                err = close(pre_mod.flash_prefill(
                    a[0], a[1], a[2], kw.get("causal", True), *tile),
                    want_out, F32_PREFILL_TOL)
                t0 = time.perf_counter()
                oob = pre_mod.out_of_bounds(a[0], a[1], a[2],
                                            kw.get("causal", True), *tile)
                lib, tol = "flash_prefill_checked", F32_PREFILL_TOL
            else:
                tile = (autotune.tile_for("flash_decode", a[1].shape[2],
                                          model.policy, device),)
                err = close(dec_mod.flash_decode(
                    a[0], a[1], a[2], bias_of(a, kw), *tile), want_out,
                    F32_DECODE_TOL)
                t0 = time.perf_counter()
                oob = dec_mod.out_of_bounds(a[0], a[1], a[2],
                                            bias_of(a, kw), *tile)
                lib, tol = "flash_decode_checked", F32_DECODE_TOL
            oob_ms = (time.perf_counter() - t0) * 1e3
            err_c = close(oob["out"], want_out, tol)
            checked[lib].append(dict(
                arch=f"{arch} (reduced)", kind=kind, count=oob["count"],
                ms=oob_ms, err=err_c, tile=list(tile),
                shape=[tuple(a[0].shape), tuple(a[1].shape)]))
            log(f"[check] N {arch} {kind}: q {tuple(a[0].shape)}, k "
                f"{tuple(a[1].shape)} float32: kernel vs plain {err:.3g}; "
                f"{lib} at tile {tile}: {oob['count']} accesses outside the "
                f"operands {oob['loads'][:4]}, its output vs plain "
                f"{err_c:.3g}")
            assert oob["count"] == 0, (arch, kind, oob)
        del firsts
        # -- the kernels at this architecture's shapes, beside SDPA --------
        out["kernel_times"] = arch_kernel_times(
            args, device, cfg, B, S, total, want, True, phase="N")
        out["attention_errs"] = {}
        for r in out["kernel_times"]:
            name = "flash_prefill" if r["kind"].startswith("prefill") \
                else "flash_decode"
            out["attention_errs"][name] = max(
                out["attention_errs"].get(name, 0.0), r["err"])
        out["seconds"] = time.perf_counter() - t_arch
        log(f"[N] {arch} in {out['seconds']:.1f} s")
        return out

    for arch in ARCHS_N:
        try:
            e2e["archs"][arch] = one(arch)
        except Exception:  # the next architecture still runs
            failures.append(f"{arch}: {traceback.format_exc()}")
            log(f"[N] {arch} FAILED:\n{failures[-1]}")
        gc_cuda(on_card)

    # -- launch.train on the reduced config -----------------------------------
    work = Path(tempfile.mkdtemp(prefix="phase_n_"))
    try:
        cfg = configs.reduced(configs.get_config(TRAIN_ARCH))
        argv = ["--steps", str(train_steps), "--ckpt-dir",
                str(work / "cli"), "--device", str(device)]
        t0 = time.perf_counter()
        reset_counts(kernels)
        with counting_calls(plain_targets) as plain_calls:
            trained = train_mod.main(argv)
            sync()
        got = launch_counts(kernels)
        for k, v in got.items():
            launches[k] += v
        log(f"[N] launch.train.main({' '.join(argv)}): launches "
            f"{ {k: v for k, v in got.items() if v} }; plain attention "
            f"calls {plain_calls}; losses {trained['losses']}; "
            f"{time.perf_counter() - t0:.1f} s")
        assert len(trained["losses"]) == train_steps and all(
            math.isfinite(x) for x in trained["losses"])
        if on_card:
            runs = 1 if cfg.remat == "none" else 2
            assert got["flash_prefill"] == runs * cfg.n_layers * \
                train_steps, got
            assert got["flash_decode"] == 0, got
            assert all(v == 0 for v in plain_calls.values()), plain_calls
        e2e["train"] = {"losses": trained["losses"], "launches": got}
        del trained
        # the gradients: the kernel route against the plain route
        model = init_model(cfg, args.seed, device=device, policy=policy)
        gen = torch.Generator().manual_seed(args.seed + 38)
        batch = {k: torch.randint(0, cfg.vocab, (8, 64), generator=gen
                                  ).to(device)
                 for k in ("tokens", "targets")}

        def grads():
            model.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, batch)
            loss.backward()
            sync()
            return {n: p.grad.detach().clone()
                    for n, p in model.named_parameters()}

        g_k = grads()
        model.policy = KernelPolicy(enabled=False)
        g_p = grads()
        model.policy = policy
        rel = {n: float((g_k[n] - g_p[n]).norm() / g_p[n].norm())
               for n in g_p if float(g_p[n].abs().max()) > 0}
        worst = max(rel.values())
        log(f"[check] N train gradients of {len(rel)} parameters, kernel "
            f"route vs plain route (B 8, S 64, float32): largest "
            f"||g_k - g_p|| / ||g_p|| {worst:.3g} (bound {TRAIN_GRAD_TOL})")
        assert worst <= TRAIN_GRAD_TOL, sorted(rel.items(),
                                               key=lambda kv: -kv[1])[:4]
        e2e["train"]["grad_rel_err"] = worst
        del model, g_k, g_p
    except Exception:
        failures.append(f"train: {traceback.format_exc()}")
        log(f"[N] launch.train FAILED:\n{failures[-1]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if cli is not None:
        text, _ = cli.communicate(timeout=300)
        for line in text.splitlines()[-6:]:
            log(f"[N.cli] {line}")
        log(f"[N.cli] python -m repro_torch.launch.serve --mode lm exited "
            f"{cli.returncode}")
        if cli.returncode != 0:
            failures.append(f"serve --mode lm: exit {cli.returncode}")
        e2e["cli_rc"] = cli.returncode
        # its own count of the D 16 kernels' launches: one prefill and
        # every decode step through them, as the reduced smollm's routes
        try:
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("[serve] kernels "))
            ran = json.loads(line[len("[serve] kernels "):])
            routes = ARCH_ROUTES_N["smollm_135m"]
            want = {"flash_prefill": routes[0] + routes[1],
                    "flash_decode": routes[3] * ran["decode_steps"]}
            for k, n in want.items():
                tiles = ran[k]["instances"]
                assert ran[k]["launches"] == n and ran["decode_steps"] > 0 \
                    and tiles and all(t.startswith("float32 D16")
                                      for t in tiles), (k, n, ran)
            e2e["cli_kernels"] = ran
        except Exception:
            failures.append(f"serve --mode lm kernels: "
                            f"{traceback.format_exc()}")
            log(f"[N.cli] FAILED:\n{failures[-1]}")
    e2e["checked"] = checked
    e2e["seconds"] = time.perf_counter() - t_phase
    log(f"[N] {e2e['seconds']:.1f} s")
    assert not failures, "phase N failed for " + "; ".join(
        f.split(":")[0] for f in failures)
    return launches, e2e


def ulp_noise(fn, seed: int):
    """``fn`` (an attention wrapper) with each output moved one bf16 ulp
    up or down on a random half of its elements, from a generator seeded
    with ``seed`` on the output's device."""
    import torch

    gens = {}

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        gen = gens.get(out.device)
        if gen is None:
            gen = gens[out.device] = torch.Generator(
                device=out.device).manual_seed(seed)
        _, e = torch.frexp(out.float())
        ulp = torch.ldexp(torch.ones_like(out, dtype=torch.float32), e - 8)
        u = torch.rand(out.shape, generator=gen, device=out.device)
        step = torch.where(u < 0.25, -1.0, torch.where(u < 0.5, 1.0, 0.0))
        return (out.float() + step * ulp).to(out.dtype)

    return wrapped


def cuda_census(top: int = 8) -> list:
    """The live CUDA tensors the garbage collector finds, summed by shape
    and dtype, the largest ``top``: (shape, dtype, count, bytes)."""
    import collections
    import gc

    import torch

    gc.collect()
    count, nbytes = collections.Counter(), collections.Counter()
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            key = (tuple(o.shape), str(o.dtype))
            count[key] += 1
            nbytes[key] += o.untyped_storage().nbytes()
    return [(k[0], k[1], count[k], b) for k, b in nbytes.most_common(top)]


def gc_cuda(on_card: bool) -> None:
    """Collect what was released and return the card's cached blocks."""
    import gc

    import torch

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def profile_by_kind(events, kinds: dict) -> dict:
    """Device ms of a ``torch.profiler`` trace's kernels by kind: those
    launched inside a range named in ``kinds`` (label -> kind) count to its
    kind, except, for a kind ending in ``/``, its matrix products; every
    other kernel by ``kernel_kind`` (attention kernels, matrix products,
    the rest)."""
    from torch.autograd import DeviceType

    spans = {e.name for e in events if getattr(e, "is_user_annotation", False)}

    def kernels(e):
        return [k for k in e.kernels if k.name not in spans] + [
            k for c in e.cpu_children for k in kernels(c)]

    split = {"attention": 0.0, "matmul": 0.0, "rest": 0.0}
    split.update({k.rstrip("/"): 0.0 for k in kinds.values()})
    for e in events:
        if is_device_work(e) and e.name not in spans:
            split[kernel_kind(e.name)] += e.self_device_time_total / 1e3
    for e in events:
        kind = kinds.get(e.name)
        if kind is None or e.device_type != DeviceType.CPU:
            continue
        for k in kernels(e):
            by = kernel_kind(k.name)
            if kind.endswith("/") and by == "matmul":
                continue
            split[by] -= k.duration / 1e3
            split[kind.rstrip("/")] += k.duration / 1e3
    return split


def arch_kernel_times(args, device, cfg, B: int, S: int, total: int,
                      want: tuple, reduced: bool, phase: str = "M") -> list:
    """Each kernel route of ``cfg`` at its serving shapes on random bf16
    operands (float32 for a ``reduced`` config): the wrapper's ms (CUDA
    events), its device ms (calls queued back to back behind a sleep of
    the card, ``autotune._default_timer``: the profiler loses events late
    in a long process), its plain version's ms and error against it
    (``BF16_TOL``; float32 ``F32_PREFILL_TOL``, ``F32_DECODE_TOL``),
    SDPA's ms (``None`` where SDPA refuses the shape), the bound (float32:
    4-byte elements and the rate outside the tensor cores), and the
    launches a prefill or a step (``want``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import autotune
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn_mod

    on_card = device.type == "cuda"
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    M = cfg.n_memory_tokens
    gen = torch.Generator(device=device).manual_seed(args.seed + 30)
    dt = torch.bfloat16 if not reduced else torch.float32

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    cases = []
    if want[0]:
        cases.append(("prefill causal", S, True, want[0]))
    if want[1]:
        cases.append(("prefill full", M, False, want[1]))
    n_cross = cfg.repeats * cfg.pattern.count("cross")
    if want[3] - n_cross:
        cases.append(("decode self", total, None, want[3] - n_cross))
    if n_cross and M:
        cases.append(("decode memory", M, None, n_cross))
    rows = []
    for kind, T, causal, per in cases:
        if kind.startswith("prefill"):
            q, k, v = randn(B, H, T, D), randn(B, KV, T, D), randn(B, KV, T, D)
            fn = (lambda q=q, k=k, v=v, c=causal:
                  ops.prefill_attention(q, k, v, causal=c))
            plain = (lambda q=q, k=k, v=v, c=causal:
                     pre_mod.flash_prefill_plain(q, k, v, c))
            lib = (lambda q=q, k=k, v=v, c=causal:
                   F.scaled_dot_product_attention(q, k, v, is_causal=c,
                                                  enable_gqa=True))
            pairs = T * (T + 1) / 2 if causal else T * T
            nbytes = q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel())
            nops = 4 * B * H * D * pairs
        else:
            q, k, v = randn(B, H, D), randn(B, KV, T, D), randn(B, KV, T, D)
            bias = (attn_mod.decode_bias(B, T, S, 0, device)
                    if kind == "decode self" else
                    torch.zeros((B, T), dtype=torch.float32, device=device))
            fn = (lambda q=q, k=k, v=v, b=bias:
                  ops.decode_attention(q, k, v, b))
            plain = (lambda q=q, k=k, v=v, b=bias:
                     dec_mod.flash_decode_plain(q, k, v, b))
            lib = (lambda q=q, k=k, v=v, b=bias:
                   F.scaled_dot_product_attention(
                       q[:, :, None], k, v, attn_mask=(b == 0)[:, None, None],
                       enable_gqa=True))
            nbytes = q.element_size() * (k.numel() + v.numel()
                                         + 2 * q.numel()) + 4 * bias.numel()
            nops = 4 * q.numel() * T
        bf16 = dt == torch.bfloat16
        err = close(fn(), plain(), BF16_TOL if bf16 else F32_PREFILL_TOL
                    if kind.startswith("prefill") else F32_DECODE_TOL)
        b_ms, b_by = bound(nbytes, nops, BF16_TC_OPS_PER_S if bf16
                           else SCALAR_OPS_PER_S)
        row = dict(kind=kind, B=B, H=H, KV=KV, keys=T, D=D, causal=causal,
                   per=per, err=err,
                   ms=timed(fn, args.reps, device),
                   plain_ms=timed(plain, 1, device),
                   library_ms=library_timed(
                       lib, args.reps, device,
                       f"{phase} {cfg.name} {kind} SDPA"),
                   bound_ms=b_ms, bound_by=b_by,
                   device_ms=(autotune._default_timer(fn) / 1e3 if on_card
                              else None))
        rows.append(row)
        lib_ms = ("refused" if row["library_ms"] is None
                  else f"{row['library_ms']:.4f}")
        dev = ("" if row["device_ms"] is None else
               f"; device {row['device_ms']:.4f} ms (calls queued behind a "
               "sleep)")
        pre = kind.startswith("prefill")
        log(f"[time] {phase} {cfg.name} {kind}: B {B}, H {H}, KV {KV}, {T} "
            f"{'queries and keys' if pre else 'keys'}, D {D}: "
            f"{row['ms']:.4f} ms{dev} (plain {row['plain_ms']:.3f}, SDPA "
            f"{lib_ms}, bound {b_ms:.4f} by {b_by}); {per} a "
            f"{'prefill' if pre else 'step'}; error vs plain {err:.3g}")
        del q, k, v
    return rows


def checked_rows(e2e: dict) -> list:
    """The kernels line's rows of the checked builds that phases M and N
    ran at each architecture's shapes: not on the main path (no launches
    there);
    their ms is a checked call's (the ranges set, the launch, the count
    read back) at the last shape checked, beside the production kernel's
    plain, bound and SDPA there."""
    sources = {"flash_prefill_tc_checked": "flash_prefill_tc.cu",
               "flash_prefill_checked": "flash_prefill.cu",
               "flash_decode_checked": "flash_decode.cu"}
    rows = []
    for name, runs in e2e["checked"].items():
        if not runs:
            continue
        last = runs[-1]
        at = next(r for r in e2e["archs"][last["arch"]]["kernel_times"]
                  if r["kind"] == last["kind"])
        decode = "decode" in name
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + sources[name],
            "replaces": ("src/repro/kernels/flash_decode.py:62" if decode
                         else "src/repro/kernels/flash_prefill.py:71"),
            "launches": 0, "max_abs_err": max(r["err"] for r in runs),
            "ms": last["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "tile": None})
        log(f"[time] {name}: {last['ms']:.4f} ms a checked call at "
            f"{last['arch']}'s {last['kind']} shape; "
            f"{sum(r['count'] for r in runs)} accesses outside the operands "
            f"over {len(runs)} shapes")
    return rows


def archs_summary(e2e: dict) -> dict:
    """Phase M's figures for one line near the end of the output: each
    architecture's serving times, peak memory, checks and, with
    ``--profile``, device time by kind; EpiQL's days; the checked builds'
    counts."""
    keys = ("params", "draw_s", "cold_s", "wall_s", "prefill_ms",
            "decode_step_mean_ms", "tokens_per_s", "peak_bytes",
            "bf16_path_err", "float32_prefill_err", "float32_decode_err",
            "profile_prefill", "profile_decode step")
    out = {a: {k: r[k] for k in keys if k in r}
           for a, r in e2e["archs"].items()}
    epi = e2e["epiql"]
    out["epiql"] = {"join_size": epi["join_size"],
                    "expected_k": epi["expected_k"],
                    "k": [k for _, k, _, _ in epi["days"]],
                    "ms": [ms for _, _, _, ms in epi["days"]]}
    out["out_of_bounds"] = {name: sum(r["count"] for r in runs)
                            for name, runs in e2e["checked"].items()}
    return out


def reduced_summary(e2e: dict) -> dict:
    """Phase N's figures for one line near the end of the output: each
    architecture's prefill and step ms and its kernel-vs-plain path
    errors, the reduced train's losses and gradient error, the CLI's exit
    code, the checked builds' counts and the phase's seconds."""
    keys = ("prefill_ms", "decode_step_mean_ms", "prefill_err",
            "decode_err")
    out = {a: {k: r[k] for k in keys} for a, r in e2e["archs"].items()}
    out.update(train=e2e.get("train"), cli_rc=e2e.get("cli_rc"),
               seconds=e2e["seconds"], out_of_bounds={
                   name: sum(r["count"] for r in runs)
                   for name, runs in e2e["checked"].items()})
    return out


# Phase J's gradient bound, set before its first run on the card: the
# largest ||g_kernel - g_plain|| / ||g_plain|| over the parameters, both
# routes in bf16 compute (attention by the kernel against the plain
# version, everything else the same). A CPU emulation of the kernel's
# numerics (tests/test_torch_attention_tc.py's prefill_tc_emulated) at
# full width and depth gave a largest 0.037 (median 0.023) at B 1, S 256
# and 0.032 (median 0.024) at B 2, S 512: bf16 rounding in 30 layers, not
# the backward. The bound is about three times that; a missing gradient
# reads 1.
TRAIN_GRAD_TOL = 0.1
TRAIN_ARCH = "smollm_135m"
# phase J's sizes: smollm's published context, a batch of 8 (16,384 tokens
# a step); run A's steps, the step after which run B is killed, the step of
# the corpus delta, and the steps of ``launch.train --full``
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_STEPS, TRAIN_KILL_AT, TRAIN_DELTA_STEP, TRAIN_CLI_STEPS = 24, 12, 8, 3
# The attention backward alone against autograd of the plain version from
# the same bf16 operands (both in float32, rounded to bf16 once): they
# differ by rowsum(dO O), taken from the bf16 output, as flash attention
# takes it. On the CPU: 0.0013 for randn operands (B 2, S 512), 0.0049 for
# three times those.
TRAIN_BWD_TOL = 2.0 ** -7


def run_training(args, device, kernels, kernel_policy=None, *,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                 kill_at=TRAIN_KILL_AT, delta_step=TRAIN_DELTA_STEP,
                 cli_steps=TRAIN_CLI_STEPS, reduced=False):
    """Phase J: LM training at smollm-135m's published widths (30 layers,
    d_model 576, H 9, KV 3, head dim 64, d_ff 1,536, vocabulary 49,152;
    135 M float32 parameters from ``--seed``, bf16 compute, remat
    ``"full"``) on Poisson-join-sampled batches of ``batch`` x ``seq``
    tokens from ``train``'s own corpus (``make_corpus_db(512, 16, seq +
    1)``). Main path: ``python -m repro_torch.launch.train --full`` through
    ``main`` (``cli_steps`` steps), then the port's
    ``train_lm_joinsampled`` run A (``steps`` steps, a corpus delta at
    ``delta_step``), each with its launches counted: two
    ``flash_prefill`` a layer a step (the forward and its recomputation),
    one ``fused_draw_batch`` a window dispatched, no plain attention call.
    Checks: every parameter's gradient through the kernel route against
    the plain route's on one batch (``TRAIN_GRAD_TOL``), the checked
    ``flash_prefill_tc`` build on the training shapes, the loss falls over
    run A, run B killed at ``kill_at`` and resumed (each leg a
    process of its own) repeats run A's losses and doc ids bit for bit with
    the version trace flipping at the delta, and a corrupted newest
    checkpoint resumes from the one before it. Prints the step's ms,
    tokens/s and peak memory and, with ``--profile``, a step's device time
    by kind. The keywords shrink it for a CPU rehearsal only (``reduced``,
    smollm's reduced config, has no kernel: head dim 16); on the card it
    runs at the constants. Returns the main path's launches and the
    numbers."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import DEFAULT_POLICY, KernelPolicy
    from repro_torch.data import PoissonJoinSource, make_corpus_db
    from repro_torch.examples import train_lm_joinsampled as example
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels import ref
    from repro_torch.launch import train as train_mod
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import init_model, loss_fn

    on_card = device.type == "cuda"
    policy = kernel_policy or DEFAULT_POLICY
    smi = nvidia_smi_line() if on_card else "cpu"
    if on_card and (reduced, batch, seq, steps, kill_at, delta_step,
                    cli_steps) != (False, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS,
                                   TRAIN_KILL_AT, TRAIN_DELTA_STEP,
                                   TRAIN_CLI_STEPS):
        raise ValueError("phase J runs at its constants on the card")
    B, S = batch, seq
    cfg = configs.get_config(TRAIN_ARCH)
    if reduced:
        cfg = configs.reduced(cfg)
    L = cfg.n_layers
    runs = 1 if cfg.remat == "none" else 2  # forwards of a layer a step
    e2e = {"arch": cfg.name, "batch": B, "seq": S, "tokens_per_step": B * S,
           "remat": cfg.remat, "grad_tol": TRAIN_GRAD_TOL, "device": smi}
    plain_targets = [(dec_mod, "flash_decode_plain"),
                     (pre_mod, "flash_prefill_plain"),
                     (ref, "flash_decode_ref"), (ref, "flash_prefill_ref"),
                     (attn_mod, "blockwise_attention")]
    work = Path(tempfile.mkdtemp(prefix="phase_j_"))
    launches = {k: 0 for k in kernels}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def main_path(label, fn):
        """``fn`` with every count at 0 before it, read after it (summed
        into the phase's launches), and the plain attention calls and the
        source's window dispatches it makes."""
        reset_counts(kernels)
        with counting_calls(plain_targets + [(PoissonJoinSource,
                                              "_dispatch")]) as calls:
            out = fn()
            sync()
        got = launch_counts(kernels)
        for k, v in got.items():
            launches[k] += v
        windows = calls.pop("PoissonJoinSource._dispatch")
        log(f"[J] {label}: launches "
            f"{ {k: v for k, v in got.items() if v} }; windows dispatched "
            f"{windows}; plain attention calls {calls}; instances (tuned "
            f"tiles) {window_tiles(kernels)}")
        return out, got, windows, calls

    def assert_launches(got, windows, calls, steps):
        if on_card:
            assert got["flash_prefill"] == runs * L * steps, got
            assert got["fused_draw_batch"] == windows >= 1, (got, windows)
            assert got["flash_decode"] == 0, got
            assert all(v == 0 for v in calls.values()), calls

    try:
        # -- 1. the entry point: python -m repro_torch.launch.train --full ----
        argv = ["--seq-len", str(S), "--batch", str(B), "--steps",
                str(cli_steps), "--ckpt-dir", str(work / "cli"),
                "--device", str(device)] + ([] if reduced else ["--full"])
        t0 = time.perf_counter()
        out, got, windows, calls = main_path(
            f"launch.train.main({' '.join(argv)})",
            lambda: train_mod.main(argv))
        assert_launches(got, windows, calls, cli_steps)
        assert all(math.isfinite(x) for x in out["losses"])
        log(f"[J] launch.train --full: {cli_steps} steps of {B} x "
            f"{S} tokens in {time.perf_counter() - t0:.1f} s (model, corpus "
            f"and first-step set-up included); losses {out['losses']}")
        del out
        shutil.rmtree(work / "cli", ignore_errors=True)

        # -- 2. gradients: the kernel route against the plain route -----------
        model = init_model(cfg, args.seed, device=device, policy=policy)
        db = make_corpus_db(512, 16, S + 1, cfg.vocab, seed=args.seed,
                            device=device)
        batch = PoissonJoinSource(db, S + 1, B, seed=args.seed,
                                  kernel_policy=policy).batch_at(0)
        batch = {"tokens": batch["tokens"], "targets": batch["targets"]}

        def grads():
            model.zero_grad(set_to_none=True)
            t0 = time.perf_counter()
            loss, _ = loss_fn(model, batch)
            loss.backward()
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            return float(loss.detach()), ms, {n: p.grad.detach().clone()
                                     for n, p in model.named_parameters()}

        count0 = pre_mod.flash_prefill.launches
        with counting_calls(plain_targets) as calls:
            loss_k, ms_k, g_k = grads()
        fwd = pre_mod.flash_prefill.launches - count0
        model.policy = KernelPolicy(enabled=False)
        loss_p, ms_p, g_p = grads()
        model.policy = policy
        rel = {n: float((g_k[n].float() - g_p[n].float()).norm()
                        / g_p[n].float().norm()) for n in g_p}
        zero = [n for n in g_p if float(g_k[n].abs().max()) == 0
                or float(g_p[n].abs().max()) == 0]
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
        log(f"[check] J gradients of all {len(rel)} parameters, kernel route "
            f"vs plain route (B {B}, S {S}, one batch): largest ||g_k - g_p|| "
            f"/ ||g_p|| {worst[0][1]:.4g} (bound {TRAIN_GRAD_TOL}; median "
            f"{float(np.median(list(rel.values()))):.4g}; worst {worst}); "
            f"zero gradients {zero}; loss {loss_k:.6f} vs {loss_p:.6f}; "
            f"flash_prefill launches {fwd}, plain calls {calls}; a step's "
            f"forward and backward {ms_k:.1f} ms vs plain {ms_p:.1f} ms")
        assert not zero and all(math.isfinite(v) for v in rel.values())
        assert max(rel.values()) <= TRAIN_GRAD_TOL, worst
        if on_card:
            assert fwd == runs * L and all(v == 0 for v in calls.values())
        e2e.update(grad_rel_err_max=worst[0][1], grad_rel_err_worst=worst,
                   grad_rel_err_median=float(np.median(list(rel.values()))),
                   grad_params=len(rel), loss_kernel=loss_k,
                   loss_plain=loss_p, fwd_bwd_ms=ms_k, fwd_bwd_plain_ms=ms_p)
        del g_k, g_p

        # -- 3. the kernel at the training shapes: its checked build, its
        #    backward alone, times ---------------------------------------
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        gen = torch.Generator(device=device).manual_seed(args.seed + 27)
        qkv = [torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16) for shape in ((B, H, S, D), (B, KV, S, D),
                                          (B, KV, S, D))]
        if on_card:
            oob = pre_mod.out_of_bounds(*qkv, True)
            log(f"[check] J flash_prefill_tc checked build at B {B}, H {H}, "
                f"KV {KV}, S {S}, D {D}, causal: {oob['count']} accesses "
                f"outside q, k, v and the output {oob['loads'][:4]}")
            assert oob["count"] == 0, oob
            e2e["out_of_bounds"] = oob["count"]
        # the backward alone against autograd through the plain version
        q, k, v = (t.requires_grad_(True) for t in qkv)
        w = torch.randn((B, H, S, D), generator=gen, device=device).to(
            torch.bfloat16)
        out = pre_mod.flash_prefill_plain(q, k, v, True)
        want = torch.autograd.grad(out, (q, k, v), w)
        got = pre_mod.flash_prefill_backward(
            q.detach(), k.detach(), v.detach(), out.detach(), w, True)
        bwd_err = max(float((g.float() - r.float()).norm()
                            / r.float().norm()) for g, r in zip(got, want))
        log(f"[check] J attention backward at the training shapes vs "
            f"autograd of the plain version (bf16 operands): largest "
            f"||d - d_plain|| / ||d_plain|| over dq, dk, dv {bwd_err:.3g} "
            f"(bound {TRAIN_BWD_TOL})")
        assert bwd_err <= TRAIN_BWD_TOL
        e2e["backward_rel_err"] = bwd_err
        del want, got
        # the kernel and its backward at these shapes, beside SDPA's
        q, k, v = (t.detach() for t in (q, k, v))
        o = ops_mod.prefill_attention(q, k, v)

        def sdpa_fwd_bwd():
            x = [t.clone().requires_grad_(True) for t in (q, k, v)]
            y = F.scaled_dot_product_attention(*x, is_causal=True,
                                               enable_gqa=True)
            return torch.autograd.grad(y, x, w)

        k_times = {
            "ms": timed(lambda: ops_mod.prefill_attention(q, k, v),
                        args.reps, device),
            "library_ms": library_timed(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                args.reps, device, "J prefill SDPA"),
            "bound_ms": bound(2 * (2 * q.numel() + k.numel()
                                   + v.numel()), 2 * q.numel() * S,
                              BF16_TC_OPS_PER_S)[0],
            "plain_ms": timed(lambda: pre_mod.flash_prefill_plain(
                q, k, v, True), 1, device),
            "backward_ms": timed(lambda: pre_mod.flash_prefill_backward(
                q, k, v, o, w, True), args.reps, device),
            "library_fwd_bwd_ms": library_timed(
                sdpa_fwd_bwd, args.reps, device, "J SDPA fwd + bwd")}
        e2e["kernel_times"] = k_times
        lib = {key: "refused" if val is None else f"{val:.4f}"
               for key, val in k_times.items()}
        log(f"[time] J flash_prefill at B {B}, H {H}, KV {KV}, S {S}, D "
            f"{D} causal: {k_times['ms']:.4f} ms (plain "
            f"{k_times['plain_ms']:.3f}, SDPA {lib['library_ms']}, bound "
            f"{k_times['bound_ms']:.4f}); its backward (torch operations "
            f"in float32) {k_times['backward_ms']:.3f} ms, SDPA's forward "
            f"and backward {lib['library_fwd_bwd_ms']}; {smi}")
        del qkv, q, k, v, w, o, out

        # -- 4. profile: a step's device time by kind -------------------------
        if on_card and args.profile:
            e2e["profile_step"] = profile_train_step(model, batch, smi)
        del model, db, batch
        if on_card:
            torch.cuda.empty_cache()

        # -- 5. the integration run: A in this process, B in children ---------
        held = torch.cuda.memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        stamps = []
        hooks = {"on_step": lambda step, loss: stamps.append(
            (step, time.perf_counter()))}
        kill, at = kill_at, delta_step
        t0 = time.perf_counter()
        res, got, windows, calls = main_path(
            "train_lm_joinsampled run A", lambda: example.run_integration(
                steps, kill, at, B, S, work / "int",
                full=not reduced, device=str(device), restart=True,
                hooks=hooks))
        wall_s = time.perf_counter() - t0
        a, b = res["a"], res["b"]
        # run A's own launches: the children count theirs in their processes
        assert_launches(got, windows, calls, steps)
        peak = (int(torch.cuda.max_memory_allocated(device)) - held
                if on_card else 0)
        gaps = [(t1 - t0_) * 1e3 for (_, t0_), (_, t1) in
                zip(stamps, stamps[1:])]
        steady = sorted(gaps)
        mean = sum(gaps) / len(gaps)
        e2e.update(losses_a=a["losses"], losses_b=b["losses"],
                   versions_a=a["data_versions"], step_ms=gaps,
                   step_ms_mean=mean, step_ms_median=steady[len(steady) // 2],
                   step_ms_min=steady[0], step_ms_max=steady[-1],
                   tokens_per_s=B * S / (mean / 1e3),
                   peak_device_bytes=peak, integration_wall_s=wall_s,
                   straggler_events=len(a["straggler_events"]))
        log(f"[check] J run A: loss {a['losses'][0]:.4f} -> "
            f"{a['losses'][-1]:.4f} over {steps} steps; versions "
            f"{a['data_versions']}; run B killed after {kill} and resumed in "
            f"a new process: {len(b['losses'])} losses and doc ids equal run "
            f"A's bit for bit")
        quarter = max(steps // 4, 1)
        first = sum(a["losses"][:quarter]) / quarter
        last = sum(a["losses"][-quarter:]) / quarter
        log(f"[check] J the loss falls: mean of steps 0-{quarter - 1} "
            f"{first:.4f}, of the last {quarter} {last:.4f}")
        assert last < first, a["losses"]
        e2e.update(loss_first_quarter=first, loss_last_quarter=last)
        assert a["data_versions"] == [0] * at + [1] * (steps - at)
        log(f"[time] J step (run A, steps 1-{steps - 1}, a loop iteration: "
            f"batch, step, loss read, a due checkpoint's snapshot): mean "
            f"{mean:.2f} ms (median {e2e['step_ms_median']:.2f}, min "
            f"{steady[0]:.2f}, max {steady[-1]:.2f}); "
            f"{e2e['tokens_per_s']:.0f} tokens/s at {B} x {S}; peak device "
            f"memory {peak / 2**30:.2f} GiB over the {held / 2**30:.2f} GiB "
            f"held before; run A and B {wall_s:.1f} s; {smi}")

        # -- 6. a corrupted newest checkpoint: resume from the one before -----
        b_dir = work / "int" / "b"
        manager = CheckpointManager(str(b_dir))
        newest = manager.all_steps()[-1]
        shard = b_dir / f"step_{newest:010d}" / "shard0.npz"
        with open(shard, "r+b") as f:
            f.seek(shard.stat().st_size // 2)
            f.write(b"corrupted!")
        tc = train_mod.TrainConfig(
            arch=TRAIN_ARCH, reduced=reduced, steps=kill + 1,
            batch=B, seq_len=S, ckpt_every=kill, log_every=1000,
            ckpt_dir=str(b_dir), device=str(device))
        c = train_mod.train(dataclasses.replace(
            tc, deltas=example.delta_schedule(tc, at)))
        log(f"[check] J newest checkpoint (step {newest}) corrupted: the "
            f"restart resumed from step {kill} and step {kill}'s loss "
            f"{c['losses'][0]!r} equals run A's {a['losses'][kill]!r}")
        assert c["losses"] == a["losses"][kill:kill + 1], c["losses"]
        del a, b, c, res
    finally:
        shutil.rmtree(work, ignore_errors=True)
        if on_card:
            torch.cuda.empty_cache()
    return launches, e2e


def profile_train_step(model, batch, smi) -> dict:
    """A warm training step's device time by kind, all from one
    ``torch.profiler`` trace of the step: the attention kernel (by name),
    the attention backward (the kernels launched inside
    ``FlashPrefill.backward``'s range, ``flash_prefill.BACKWARD_RANGE``),
    the optimizer (inside ``adamw_update``'s, ``adamw.UPDATE_RANGE``), the
    matrix products outside both ranges, and the rest; the idle share of
    the step's unprofiled wall time."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim import adamw as adamw_mod

    opt_cfg = AdamWConfig(lr=3e-3)
    state = adamw_init(opt_cfg, dict(model.named_parameters()))
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        def step():
            train_mod.train_step(model, opt_cfg, state, batch, 25)
        wall = wall_ms(step, model.device)
        events = profiled(step, 1).events()
    finally:
        torch.use_deterministic_algorithms(det)
    # a range's span on the device is not work (the trace may also link it
    # to the range as one of its kernels)
    spans = {pre_mod.BACKWARD_RANGE, adamw_mod.UPDATE_RANGE} | {
        e.name for e in events if getattr(e, "is_user_annotation", False)}
    work = [e for e in events if is_device_work(e) and e.name not in spans]
    split = attention_split(work)
    busy = sum(split.values())

    def inside(name):
        """The kernels launched inside each CPU range ``name``, by kind
        (``kernel_kind``), and the ranges' count."""
        def kernels(e):
            return [k for k in e.kernels if k.name not in spans] + [
                k for c in e.cpu_children for k in kernels(c)]
        ranges = [e for e in events
                  if e.name == name and e.device_type == DeviceType.CPU]
        split = {"attention": 0.0, "matmul": 0.0, "rest": 0.0}
        for r in ranges:
            for k in kernels(r):
                split[kernel_kind(k.name)] += k.duration / 1e3
        return split, len(ranges)

    bwd, n_bwd = inside(pre_mod.BACKWARD_RANGE)
    opt, n_opt = inside(adamw_mod.UPDATE_RANGE)
    L = model.cfg.n_layers
    B, S = batch["tokens"].shape
    kinds = {"attention_kernel": split["attention"] - bwd["attention"]
             - opt["attention"],
             "attention_backward": sum(bwd.values()),
             "matmul": split["matmul"] - bwd["matmul"] - opt["matmul"],
             "optimizer": sum(opt.values()),
             "rest": split["rest"] - bwd["rest"] - opt["rest"]}
    out = dict(kinds, busy_ms=busy, wall_ms=wall,
               device_ops=sum(1 for e in work), idle_share=1 - busy / wall,
               backward_ranges=n_bwd, optimizer_ranges=n_opt)
    log(f"[profile] J a training step (B {B}, S {S}): device busy "
        f"{busy:.3f} ms of {wall:.3f} ms warm wall (idle share "
        f"{out['idle_share']:.3f}): attention kernel "
        f"{kinds['attention_kernel']:.3f}, attention backward "
        f"{kinds['attention_backward']:.3f} ({n_bwd} ranges), matrix "
        f"products {kinds['matmul']:.3f}, optimizer "
        f"{kinds['optimizer']:.3f} ({n_opt} range), the rest "
        f"{kinds['rest']:.3f}; {out['device_ops']} device operations; "
        f"{smi}")
    # each backward and the update ran in its range, and the ranges held
    # device work: the kinds are read from the trace, not estimated
    assert n_bwd == L and n_opt == 1, (n_bwd, n_opt)
    assert kinds["attention_backward"] > 0 and kinds["optimizer"] > 0, kinds
    assert min(kinds.values()) >= 0, kinds
    top = {}
    for e in work:
        top[e.key] = top.get(e.key, 0.0) + e.self_device_time_total
    for key, us in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile] J step:   {us / 1e3:8.3f} ms  {key[:80]}")
    return out


def training_summary(e2e: dict) -> dict:
    """Phase J's figures for one line near the end of the output: a step's
    ms, tokens/s, peak memory, the gradient check, the checked build and,
    with ``--profile``, a step's device time by kind."""
    keys = ("arch", "batch", "seq", "step_ms_mean", "step_ms_median",
            "step_ms_min", "step_ms_max", "tokens_per_s", "peak_device_bytes",
            "grad_rel_err_max", "grad_rel_err_median", "backward_rel_err",
            "out_of_bounds", "loss_first_quarter", "loss_last_quarter",
            "device")
    out = {k: e2e[k] for k in keys if k in e2e}
    if "profile_step" in e2e:
        out["profile_step"] = e2e["profile_step"]
    return out


# Phase K's bounds and sizes, set before its first run on the card.
# K.dp: ||g_dp - g_one|| / ||g_one|| over the parameters, one step's
# gradients over four entries (B 2 each) against one entry's (B 8), both in
# bf16 compute through the kernel. They differ by the products' shapes (M
# of 4,096 rows against 16,384: other tilings, other bf16 roundings of
# their outputs) and the sum's order. A CPU emulation at full width and
# depth (the plain attention in bf16, B 8 on one entry against 2 on each
# of four) gave a largest 0.0174 (median 0.0083) at S 256, 0.0282 (median
# 0.0222) at S 512 and 0.0174 (median 0.0079) at S 1,024; the bound is
# about three times the largest.
DP_GRAD_TOL = 0.1
DP_ENTRIES, DP_STEPS = 4, 4
# K.pipe: 5 stages of 6 layers, 8 microbatches of 1 x 1,024 tokens; the
# pipeline's hidden states against the stages applied in turn and against
# the forward pass's, relative to their norm: the same products on the same
# shapes, so one bf16 rounding (2^-8) everywhere would already be a fault.
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 5, 8, 1024
PIPE_TOL = 2.0 ** -8


def run_parallel(args, device, kernels, *, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                 steps=DP_STEPS, stages=PIPE_STAGES, micro=PIPE_MICRO,
                 pipe_seq=PIPE_SEQ, reduced=False, dryrun_argv=("--all",),
                 paper_scale=200_000, defer_dryrun=False):
    """Phase K: data parallelism, compression, the GPipe forward and the
    dry run, at smollm-135m's published widths (as J: bf16 compute, remat
    ``"full"``, parameters from ``--seed``).

    K.dp: ``train`` over a ("data" 4, "model" 1) mesh of four entries on
    the card (``TrainConfig(devices=[card] * 4)``), J's batch (8 x 2,048
    from ``PoissonJoinSource``) split 2 an entry, ``steps`` steps, launches
    counted (two ``flash_prefill`` a layer an entry a step). One step's
    gradients against the single-entry step's, leaf by leaf
    (``DP_GRAD_TOL``). Then a second DP run from the same seed and batches,
    ``steps`` calls of ``dp_train_step`` under deterministic algorithms:
    the replicas bit-equal after each step, its losses and final
    parameters bit-equal to ``train``'s, and ``compressed_psum_grads``
    over the four entries' real gradients of each step with the error
    carried: the compressed mean within scale / 2 of the exact mean of the
    corrected gradients, every new error within scale / 2, and over the
    steps the accumulated means within one quantization step of the true
    sum. With ``--profile``, a warm step's device time and idle share.

    K.pipe: ``pipeline_forward`` over a "stage" mesh of ``stages`` entries
    on the card (``transformer_stages``: 6 layers a stage) on ``micro``
    microbatches of 1 x ``pipe_seq`` tokens (launches counted: a
    ``flash_prefill`` a layer a tick, (micro + stages - 1) x 30), against
    ``reference_forward`` and the forward pass's hidden states
    (``PIPE_TOL``).

    K.dryrun: ``python -m repro_torch.launch.dryrun`` with
    ``dryrun_argv`` on ``meta`` (a line a cell, a record each) in a child
    process at the lowest priority, started after K.dp's timed run (with
    ``--profile``, after the profiled step) and joined last: each cell's
    collective bytes and dominant roofline term printed, every run cell's
    record held to carry the reference's five collective types, their
    total, the collective seconds and a dominant of the three terms;
    ``--paper`` on the card (launches counted; its gather's bytes). With
    ``defer_dryrun`` the child is left running and ``e2e["dryrun_pending"]``
    holds it for ``join_dryrun`` (the caller's, after later phases).

    The keywords shrink it for a CPU rehearsal only; on the card it runs at
    the constants. Returns the main paths' launches and the numbers."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import PoissonJoinSource, make_corpus_db
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, loss_fn, transformer
    from repro_torch.models.layers import cast, dtype_of
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import (compressed_psum_grads, pipeline_forward,
                                      reference_forward)
    from repro_torch.parallel.pipeline import transformer_stages

    on_card = device.type == "cuda"
    smi = nvidia_smi_line() if on_card else "cpu"
    if on_card and (reduced, batch, seq, steps, stages, micro, pipe_seq,
                    tuple(dryrun_argv), paper_scale) != (
            False, TRAIN_BATCH, TRAIN_SEQ, DP_STEPS, PIPE_STAGES, PIPE_MICRO,
            PIPE_SEQ, ("--all",), 200_000):
        raise ValueError("phase K runs at its constants on the card")
    cfg = configs.get_config(TRAIN_ARCH)
    if reduced:
        cfg = configs.reduced(cfg)
    L = cfg.n_layers
    runs = 1 if cfg.remat == "none" else 2  # forwards of a layer a step
    n = DP_ENTRIES
    e2e = {"arch": cfg.name, "batch": batch, "seq": seq, "entries": n,
           "grad_tol": DP_GRAD_TOL, "pipe_tol": PIPE_TOL, "device": smi}
    launches = {k: 0 for k in kernels}
    work = Path(tempfile.mkdtemp(prefix="phase_k_"))
    dry = None  # the dry run's child process
    dry_log = Path(tempfile.mkdtemp(prefix="phase_k_dryrun_")) / "dryrun.log"
    was_deterministic = torch.are_deterministic_algorithms_enabled()

    t_phase = time.perf_counter()

    def at() -> str:
        """Seconds into phase K, for its log lines."""
        return f"[{time.perf_counter() - t_phase:.1f} s into K]"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def main_path(label, fn):
        """``fn`` with every count at 0 before it, read after it (summed
        into the phase's launches)."""
        reset_counts(kernels)
        with counting_calls([(PoissonJoinSource, "_dispatch")]) as calls:
            out = fn()
            sync()
        got = launch_counts(kernels)
        for k, v in got.items():
            launches[k] += v
        log(f"[K] {label}: launches { {k: v for k, v in got.items() if v} }"
            f"; windows dispatched {calls['PoissonJoinSource._dispatch']} "
            f"{at()}")
        return out, got, calls["PoissonJoinSource._dispatch"]

    def same_bits(a, b) -> bool:
        return all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                     b.parameters()))

    def start_dryrun():
        """The dry run in a child process at the lowest priority, its
        output to ``dry_log``."""
        with open(dry_log, "w") as out:
            child = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 *dryrun_argv], stdout=out, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                                    .parent / "src"),
                         OMP_NUM_THREADS="1"))
        os.setpriority(os.PRIO_PROCESS, child.pid, 19)
        return child

    try:
        # -- K.dp 1. the entry point: train() over four entries -------------
        tc = train_mod.TrainConfig(
            arch=TRAIN_ARCH, reduced=reduced, steps=steps, batch=batch,
            seq_len=seq, seed=args.seed, ckpt_every=10 ** 6,
            log_every=10 ** 6, ckpt_dir=str(work / "a"), device=str(device),
            devices=[str(device)] * n)
        stamps = []
        hooks = {"on_step": lambda step, loss: stamps.append(
            time.perf_counter())}
        held = torch.cuda.memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        a, got, windows = main_path(
            f"train() over {n} entries, {steps} steps of {batch} x {seq}",
            lambda: train_mod.train(tc, hooks))
        wall_s = time.perf_counter() - t0
        peak = (int(torch.cuda.max_memory_allocated(device)) - held
                if on_card else 0)
        assert len(a["replicas"]) == n, len(a["replicas"])
        if on_card:
            assert got["flash_prefill"] == runs * L * n * steps, got
            assert got["fused_draw_batch"] == windows >= 1, (got, windows)
        gaps = [(t1 - t0_) * 1e3 for t0_, t1 in zip(stamps, stamps[1:])]
        mean = sum(gaps) / len(gaps)
        e2e.update(losses=a["losses"], step_ms=gaps, step_ms_mean=mean,
                   tokens_per_s=batch * seq / (mean / 1e3),
                   peak_device_bytes=peak, train_wall_s=wall_s,
                   flash_prefill_per_step=got["flash_prefill"] / steps)
        log(f"[time] K.dp step over {n} entries (steps 1-{steps - 1}, a loop "
            f"iteration): {', '.join(f'{g:.1f}' for g in gaps)} ms; peak "
            f"device memory {peak / 2**30:.2f} GiB over the "
            f"{held / 2**30:.2f} GiB held before; {steps} steps, set-up and "
            f"the last step's checkpoint {wall_s:.1f} s; {smi} {at()}")
        if not (on_card and args.profile):  # else after the profiled step
            dry, t_dry = start_dryrun(), time.perf_counter()
        # -- K.dp 2. one step's gradients: four entries against one ---------
        torch.use_deterministic_algorithms(True)
        model = init_model(cfg, args.seed, device=device)
        db = make_corpus_db(512, 16, seq + 1, cfg.vocab, seed=args.seed,
                            device=device)
        source = PoissonJoinSource(db, seq + 1, batch, seed=args.seed)
        batches = []
        for step in range(steps):
            bt = source.batch_at(step)
            batches.append({"tokens": bt["tokens"],
                            "targets": bt["targets"]})
        model.zero_grad(set_to_none=True)
        loss1, _ = loss_fn(model, batches[0])
        loss1.backward()
        loss1 = float(loss1.detach())
        g1 = {k: p.grad.detach().clone() for k, p in
              model.named_parameters()}
        model.zero_grad(set_to_none=True)
        replicas = [model] + [train_mod.replicate(model, device)
                              for _ in range(n - 1)]
        losses, grads = train_mod.entry_gradients(replicas, batches[0])
        gdp = train_mod.reduce_gradients(grads)
        rel = {k: float((gdp[k].float() - g1[k].float()).norm()
                        / g1[k].float().norm()) for k in g1}
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
        loss_dp = sum(float(x) for x in losses)
        median = float(np.median(list(rel.values())))
        log(f"[check] K.dp gradients of all {len(rel)} parameters, {n} "
            f"entries of {batch // n} rows against one of {batch}: largest "
            f"||g_dp - g_one|| / ||g_one|| {worst[0][1]:.4g} (bound "
            f"{DP_GRAD_TOL}; median {median:.4g}; worst {worst}); loss "
            f"{loss_dp:.6f} vs {loss1:.6f} {at()}")
        assert max(rel.values()) <= DP_GRAD_TOL, worst
        e2e.update(grad_rel_err_max=worst[0][1], grad_rel_err_median=median,
                   loss_dp=loss_dp, loss_one=loss1)
        del g1, gdp, grads, losses
        # -- K.dp 3. the same run by dp_train_step; compression -------------
        opt_cfg = AdamWConfig(lr=tc.lr, moment_dtype="float32")
        opt_state = adamw_init(opt_cfg, dict(model.named_parameters()))
        mesh = make_mesh((n,), ("data",), devices=device)
        names = [k for k, _ in model.named_parameters()]
        err = [{k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in r.named_parameters()} for r in replicas]
        true_sum = {k: 0.0 for k in names}
        applied = {k: 0.0 for k in names}
        worst_mean = worst_err = 0.0  # over each leaf's scale
        own_losses = []
        for step in range(steps):
            seen = []
            opt_state, met = train_mod.dp_train_step(
                replicas, opt_cfg, opt_state, batches[step], step,
                grads_out=seen)
            own_losses.append(float(met["loss"]))
            assert all(same_bits(replicas[0], r) for r in replicas[1:]), step
            means, new_err = compressed_psum_grads(seen, err, mesh, "data")
            stats = []  # per leaf: scale, slack, |mean - exact|, |new err|
            for k in names:
                corrected = torch.stack([g[k].float() + e[k]
                                         for g, e in zip(seen, err)])
                top = corrected.abs().max()
                stats.append(torch.stack([
                    top / 127.0, 4 * top * 2.0 ** -23,
                    (means[0][k].double() - corrected.double().mean(dim=0))
                    .abs().max().float(),
                    torch.stack([e[k].abs().max() for e in new_err]).max()]))
                true_sum[k] = true_sum[k] + torch.stack(
                    [g[k].double() for g in seen]).mean(dim=0)
                applied[k] = applied[k] + means[0][k].double()
            scale, slack, dm, de = torch.stack(stats).T.double().cpu()
            assert bool(torch.all(dm <= scale / 2 + slack)), step
            assert bool(torch.all(de <= scale / 2 + slack)), step
            live = scale > 0
            worst_mean = max(worst_mean, float((dm[live] / scale[live]).max()))
            worst_err = max(worst_err, float((de[live] / scale[live]).max()))
            err = new_err
            del seen, means, corrected
        acc = torch.stack([(true_sum[k] - applied[k]).abs().max()
                           for k in names]).cpu()
        assert bool(torch.all(acc <= scale + slack))
        worst_acc = float((acc[live] / scale[live]).max())
        equal_run = own_losses == a["losses"] and all(
            same_bits(x, y) for x, y in zip(a["replicas"], replicas))
        log(f"[check] K.dp {steps} steps of dp_train_step from the same seed "
            f"and batches: the {n} replicas bit-equal after each step; "
            f"losses {own_losses} and every replica's parameters bit-equal "
            f"to train()'s: {equal_run}; compressed_psum_grads over the "
            f"entries' gradients, error carried: the mean within "
            f"{worst_mean:.4f} scale of the exact mean (bound 0.5), new "
            f"errors within {worst_err:.4f} scale (bound 0.5), the "
            f"accumulated means within {worst_acc:.4f} of the last step's "
            f"scale of the true sum (bound 1) {at()}")
        assert equal_run, (own_losses, a["losses"])
        e2e.update(compress_mean_over_scale=worst_mean,
                   compress_err_over_scale=worst_err,
                   compress_accumulated_over_scale=worst_acc)
        del true_sum, applied, err, new_err, a, db, source
        torch.use_deterministic_algorithms(was_deterministic)
        # -- K.dp 4. (--profile) a warm step's device time and idle share ---
        if on_card and args.profile:
            def step_fn():
                return train_mod.dp_train_step(replicas, opt_cfg, opt_state,
                                               batches[0], steps)

            wall = wall_ms(step_fn, device)
            e2e["profile_step"] = profile_window(
                step_fn, f"K.dp step over {n} entries", wall)
            e2e["profile_step"]["wall_ms"] = wall
            log(f"[K] profiled {at()}")
        if dry is None:
            dry, t_dry = start_dryrun(), time.perf_counter()
        model = replicas[0]
        del replicas[1:], batches, opt_state
        if on_card:
            torch.cuda.empty_cache()

        # -- K.pipe: the GPipe forward over a stage axis ---------------------
        gen = torch.Generator(device=device).manual_seed(args.seed + 28)
        tokens = torch.randint(0, cfg.vocab, (micro, 1, pipe_seq),
                               generator=gen, device=device)
        dt = dtype_of(cfg.compute_dtype)
        with torch.no_grad():
            h0 = torch.stack([cast(model.embed, dt)[t] for t in tokens])
            fn, params = transformer_stages(model, stages)
            pmesh = make_mesh((stages,), ("stage",), devices=device)
            t0 = time.perf_counter()
            got_h, got, _ = main_path(
                f"pipeline_forward: {stages} stages of {L // stages} layers,"
                f" {micro} microbatches of 1 x {pipe_seq}",
                lambda: pipeline_forward(fn, params, h0, pmesh))
            pipe_ms = (time.perf_counter() - t0) * 1e3
            ticks = micro + stages - 1
            if on_card:
                assert got["flash_prefill"] == ticks * L, got
            want = reference_forward(fn, params, h0)
            fwd = torch.stack([transformer._stack(model, t, None)[0]
                               for t in tokens])
            sync()

        def rel_err(x, y):
            return float((x.float() - y.float()).norm() / y.float().norm())

        e_ref, e_fwd = rel_err(got_h, want), rel_err(got_h, fwd)
        log(f"[check] K.pipe {ticks} ticks of {stages} stages: hidden states "
            f"against reference_forward {e_ref:.3g} (bit-equal "
            f"{torch.equal(got_h, want)}), against the forward pass's "
            f"{e_fwd:.3g} (bit-equal {torch.equal(got_h, fwd)}); bound "
            f"{PIPE_TOL:.4g}; {pipe_ms:.1f} ms; {smi} {at()}")
        assert e_ref <= PIPE_TOL and e_fwd <= PIPE_TOL
        e2e.update(pipe_ticks=ticks, pipe_launches=got["flash_prefill"],
                   pipe_err_reference=e_ref, pipe_err_forward=e_fwd,
                   pipe_ms=pipe_ms)
        del model, replicas, params, h0, got_h, want, fwd
        if on_card:
            torch.cuda.empty_cache()

        # -- K.dryrun: the paper cell on the card, then the child's cells ----
        paper = []
        for multi in (False, True):
            rec, _, _ = main_path(
                f"launch.dryrun --paper ({'2x16' if multi else '16'} "
                f"entries)", lambda: dryrun.run_paper_cell(
                    multi, scale=paper_scale, device=device))
            assert rec["per_shard_capacity"] > 0 and rec["join_size"] > 0
            assert rec["collective_total_bytes"] > 0, rec
            paper.append(rec)
        e2e["paper"] = paper
        e2e["dryrun_pending"] = dict(child=dry, started=t_dry, log=dry_log,
                                     argv=tuple(dryrun_argv))
        if defer_dryrun:  # a later failure's exit stops it too
            atexit.register(stop_child, dry)
        else:
            join_dryrun(e2e)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
        if "dryrun_pending" not in e2e and dry is not None:
            # an earlier step failed: the child goes too
            stop_child(dry)
            shutil.rmtree(dry_log.parent, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
        if on_card:
            torch.cuda.empty_cache()
    return launches, e2e


def stop_child(child) -> None:
    """Kill ``child`` (a ``subprocess.Popen``) if it still runs, and reap
    it."""
    if child.poll() is None:
        child.kill()
        child.wait()


def join_dryrun(e2e: dict) -> None:
    """K.dryrun's end: waits for the child ``run_parallel`` started
    (``e2e.pop("dryrun_pending")``), logs its lines, holds its records (the
    state of every run cell fits 80 GB a device; each carries the
    reference's five collective types, their total, the collective
    seconds and a dominant of three terms) and adds the figures to
    phase K's ``e2e``. The child is killed if this fails."""
    import shutil

    from repro_torch import configs
    from repro_torch.launch import dryrun

    pending = e2e.pop("dryrun_pending")
    dry, t_dry, dryrun_argv = (pending["child"], pending["started"],
                               pending["argv"])
    try:
        t_wait = time.perf_counter()
        rc = dry.wait(timeout=900)
        waited = time.perf_counter() - t_wait
        dry_s = time.perf_counter() - t_dry
        for line in pending["log"].read_text().splitlines():
            if line.strip():
                log(f"[K.dryrun] {line}")
        assert rc == 0, rc
        cells = [(a_, s_, m_) for a_ in configs.ARCHS for s_ in configs.SHAPES
                 for m_ in ("16x16", "2x16x16")]
        if "--all" not in dryrun_argv:
            i = list(dryrun_argv)
            cells = [(i[i.index("--arch") + 1], i[i.index("--shape") + 1],
                      "16x16")]
        recs = [json.loads((dryrun.OUT_DIR / f"{a_}__{s_}__{m_}.json")
                           .read_text()) for a_, s_, m_ in cells]
        run_cells = [r for r in recs if "skipped" not in r]
        one = sorted({f"{r['arch']} {r['shape']}" for r in run_cells
                      if r["one_card"]["fits_80gb"]})
        log(f"[check] K.dryrun: {len(recs)} records, {len(run_cells)} cells "
            f"run, {len(recs) - len(run_cells)} skipped by "
            f"shape_applicable; the child ran {dry_s:.1f} s ({waited:.1f} s "
            f"waited for at the end); every cell's state fits 80 GB a "
            f"device: {all(r['fits_80gb'] for r in run_cells)}; one card "
            f"alone holds {one}")
        assert all(r["fits_80gb"] for r in run_cells)
        # the collective bytes (launch/comm_cost.py): every run cell's
        # record carries them, under the reference's names and kinds
        coll = {}
        for r in run_cells:
            roof = r["roofline"]
            ok = (sorted(r.get("collective_bytes") or ()) ==
                  sorted(dryrun.COLLECTIVES)
                  and r.get("collective_total_bytes") is not None
                  and roof.get("collective_s") is not None
                  and roof.get("dominant") in ("compute", "memory",
                                               "collective"))
            assert ok, r
            coll[f"{r['arch']} {r['shape']} {r['mesh']}"] = [
                r["collective_total_bytes"], roof["dominant"]]
            counted = r["collectives_counted"]
            log(f"[K.dryrun] {r['arch']} {r['shape']} {r['mesh']}: "
                f"collective_total_bytes {r['collective_total_bytes']:.4e} "
                f"a device (collective {roof['collective_s']:.4g} s at "
                f"{roof['link_bytes_per_s']:.3g} B/s"
                f"{'; an upper bound' if counted['upper_bound'] else ''}), "
                f"dominant {roof['dominant']}")
        dominant = {d: sum(v[1] == d for v in coll.values())
                    for d in ("compute", "memory", "collective")}
        log(f"[check] K.dryrun: {len(coll)} run cells carry collective "
            f"bytes, their total, collective_s and a dominant of three, "
            f"counted on torch "
            f"{sorted({r['collectives_counted']['torch'] for r in run_cells})}"
            f"; "
            f"cells by dominant term {dominant}; the paper cell's gather "
            f"{[r['collective_total_bytes'] for r in e2e['paper']]} bytes")
        e2e.update(dryrun_cells=len(run_cells), dryrun_records=len(recs),
                   dryrun_one_card=one, dryrun_s=dry_s, dryrun_waited_s=waited,
                   dryrun_collectives=coll)
    finally:
        stop_child(dry)
        shutil.rmtree(pending["log"].parent, ignore_errors=True)


def parallel_summary(e2e: dict) -> dict:
    """Phase K's figures for one line near the end of the output."""
    keys = ("arch", "batch", "seq", "entries", "step_ms", "step_ms_mean",
            "tokens_per_s", "peak_device_bytes", "flash_prefill_per_step",
            "grad_rel_err_max", "grad_rel_err_median",
            "compress_mean_over_scale", "compress_err_over_scale",
            "compress_accumulated_over_scale", "pipe_ticks", "pipe_launches",
            "pipe_err_reference", "pipe_err_forward", "pipe_ms",
            "dryrun_cells", "dryrun_records", "dryrun_one_card", "dryrun_s",
            "dryrun_waited_s", "dryrun_collectives", "device")
    out = {k: e2e[k] for k in keys if k in e2e}
    if "profile_step" in e2e:
        out["profile_step"] = {k: e2e["profile_step"][k]
                               for k in ("busy_ms", "idle_share", "wall_ms")}
    out["paper"] = [{k: r[k] for k in ("mesh", "entries", "join_size",
                                       "draw_ms", "peak_device_bytes",
                                       "per_shard_capacity", "build_s",
                                       "collective_total_bytes")}
                    for r in e2e.get("paper", [])]
    return out


# Phase L's shapes: probe and query counts and sequence lengths that are
# no multiple of any candidate tile (256 to 2,048 probes, 64 to 256 keys).
TUNE_PROBES = 5 * 2048 + 37
TUNE_SEQ = 1000
TUNE_CHECK_SEQ = 200  # the checked prefill's smallest ragged S
# the GET's trees beside A's three nodes: chains of these many relations,
# which reach every tree_get instance (2, 4, 8 and 16 slots)
TUNE_CHAINS = (2, 4, 8, 16)
# (H, KV) a head dim: smollm-135m, llama3-405b's G = 16 over one KV head,
# gemma3-1b; at D 16 (float32 only) llama3-405b's reduced config
TUNE_WIDTHS = {64: (9, 3), 128: (16, 1), 256: (4, 1), 16: (16, 1)}
# tree_get_kernel, bsearch_probe_kernel, flash_decode_tc_kernel,
# flash_prefill_tc_kernel and flash_prefill_kernel instances each build
# holds (the tuning's candidates at every tree size and head dim)
TUNE_INSTANCES = {"tree_get": 15, "bsearch_probe": 4, "flash_decode": 6,
                  "flash_prefill_tc": 10, "flash_prefill": 5}


def chain_tables(relations: int, seed: int):
    """A chain R0(a0, a1) |><| R1(a1, a2) |><| ... of ``relations``
    relations, 64 rows each with keys in [0, 32) (about two matches a
    step), from numpy: a GET tree of ``relations`` nodes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {f"R{i}": {f"a{i}": rng.integers(0, 32, 64),
                      f"a{i + 1}": rng.integers(0, 32, 64)}
            for i in range(relations)}


def run_tuning(args, device, smi: str, prefA, packA, nA: int) -> dict:
    """Phase L, tuning: ``autotune --check`` on the committed table; a
    sweep on this card into a scratch table (never the committed one),
    each candidate's time logged with the card's name and power limit;
    then every candidate instance of the five tuned kernels and of the
    float32 attention kernels against its plain version at ragged shapes
    (the GET and the bsearch bit for bit, with their tile models; the
    attention kernels within phase D's tolerances), and the checked builds
    of the GET and the bf16 prefill at every candidate on their smallest
    ragged shape and of the decode (both dtypes) on its ragged shape, with
    no access outside the operands."""
    import torch

    from repro_torch.config import backend_key
    from repro_torch.core import (Atom, Database, JoinQuery, PagedArena,
                                  build_shred)
    from repro_torch.kernels import autotune
    from repro_torch.kernels import bsearch_probe as bp_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as dec_mod
    from repro_torch.kernels import flash_prefill as pre_mod
    from repro_torch.kernels import tree_probe as tp_mod

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    out: dict = {"device": smi}
    # -- L.check: the committed table ---------------------------------------
    assert autotune.check_table(out=lambda m: log(f"[L.check] {m}")) == 0
    key = backend_key(device)
    committed = autotune.load_table().get("entries", {})
    log(f"[L.check] entries {sorted(committed)}; this card's key {key!r}: "
        + ("tuned" if key in committed else "no entry (the default runs)"))

    # -- L.sweep: every candidate timed on this card, into a scratch table --
    if on_card:
        lines = []

        def record(msg):
            lines.append(msg)
            log(f"[L.sweep] {msg} ({smi})")

        scratch = build.BUILD_DIR.parent / "tune" / "TUNE_TABLE.sweep.json"
        scratch.parent.mkdir(parents=True, exist_ok=True)
        scratch.unlink(missing_ok=True)
        t0 = time.perf_counter()
        winners = autotune.sweep(device=device, rounds=2, write=True,
                                 path=scratch, entry_key=key, out=record)
        assert autotune.check_table(scratch, out=lambda m: log(
            f"[L.sweep] {m}")) == 0
        agree = {k: rows == committed.get(key, {}).get(k)
                 for k, rows in winners.items()}
        log(f"[L.sweep] {time.perf_counter() - t0:.1f} s; winners {winners}; "
            f"equal to the committed entry: {agree}")
        out["sweep"] = {"lines": lines, "winners": winners,
                        "equal_to_committed": agree}

    # -- L.host: what resolving a tile costs a kernel call on the host -----
    autotune._resolve.cache_clear()
    t0 = time.perf_counter()
    first = autotune.tile_for("flash_prefill", 894, None, device)
    cold_us = (time.perf_counter() - t0) * 1e6
    calls = 10_000
    t0 = time.perf_counter()
    for _ in range(calls):
        autotune.tile_for("flash_prefill", 894, None, device)
    warm_us = (time.perf_counter() - t0) * 1e6 / calls
    log(f"[L.host] tile_for('flash_prefill', 894) = {first}: the first "
        f"call {cold_us:.1f} us (the ladder walked: the card's name, the "
        f"table's rows), then {warm_us:.3f} us a call (the mean of "
        f"{calls}, from the cache)")
    out["tile_for_us"] = {"first": cold_us, "cached": warm_us}

    # -- L.GET: every tree_get instance, at A's tree and the chains ---------
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed + 7)
    cands = autotune.KERNELS["tree_probe"].candidates
    trees = [("A", packA, nA)]
    for r in TUNE_CHAINS:
        q = JoinQuery(tuple(Atom.of(f"R{i}", f"a{i}", f"a{i + 1}")
                            for i in range(r)))
        shred = build_shred(Database.from_columns(
            chain_tables(r, args.seed + r), device=device), q, rep="usr")
        trees.append((f"chain of {r}", shred.packed, int(shred.join_size)))
    seen, oob_get = set(), 0
    for label, packed, n in trees:
        layout = packed.layout
        pos = torch.randint(0, n, (TUNE_PROBES,), generator=gen,
                            device=device, dtype=torch.int32)
        # a view of its own, not the one kept with the index
        # (``from_packed``): A's stacked pages (0.9 GiB) go with it
        pv = PagedArena(packed.arena, packed.layout)
        stacked, P = pv.stacked()
        sbases = tp_mod.stacked_bases(layout, P)
        for order, pp in (("sorted", torch.sort(pos).values),
                          ("shuffled", pos)):
            want = tp_mod.tree_probe_plain(packed.arena, pp, layout)
            for br in cands:
                items = tp_mod.items_for(layout.num_slots, br)
                seen.add((min(s for s in (2, 3, 4, 8, 16)
                              if s >= layout.num_slots), items))
                got = tp_mod.tree_probe(packed.arena, pp, layout,
                                        block_rows=br)
                model = torch.stack(tp_mod.tree_walk_tiled(
                    packed.arena, pp, layout, tile=tp_mod.THREADS * items))
                assert torch.equal(got, want), (label, order, br)
                assert torch.equal(model, want), (label, order, br)
                for dma in (None, True):
                    assert torch.equal(tp_mod.tree_probe_paged(
                        pv, pp, dma=dma, block_rows=br), want), (label, br)
                if order == "shuffled" and on_card:
                    small = pp[:2 * tp_mod.THREADS * items + 37]
                    for operand, bases in ((packed.arena, None),
                                           (stacked, sbases)):
                        oob = tp_mod.out_of_bounds(operand, small, layout,
                                                   bases, block_rows=br)
                        assert oob["count"] == 0, (label, br, oob)
                        oob_get += oob["count"]
        log(f"[L.GET] {label} ({layout.num_slots} nodes, join {n}): "
            f"{TUNE_PROBES} sorted and shuffled probes at block_rows "
            f"{cands} (probes a thread "
            f"{[tp_mod.items_for(layout.num_slots, b) for b in cands]}): "
            "tree_probe and tree_probe_paged (dma None, True) equal the "
            "plain version and the tile model bit for bit; checked build "
            + ("0 accesses outside the operands (arena and stacked pages, "
               "2 tiles + 37 probes)" if on_card else "not run"))
    # (slots of the instance, probes a thread)
    assert len(seen) == TUNE_INSTANCES["tree_get"], sorted(seen)
    out["tree_get_instances"] = sorted(seen)

    # -- L.bsearch ----------------------------------------------------------
    qA = torch.randint(0, int(prefA[-1]) + 1, (TUNE_PROBES,), generator=gen,
                       device=device, dtype=torch.int32)
    for order, qq in (("sorted", torch.sort(qA).values), ("shuffled", qA)):
        want = bp_mod.bsearch_probe_plain(prefA, qq)
        line = []
        for br in autotune.KERNELS["bsearch_probe"].candidates:
            stats, model_stats = {}, {}
            got = bp_mod.bsearch_probe(prefA, qq, stats=stats, block_rows=br)
            model = bp_mod.bsearch_probe_tiled(
                prefA, qq, tile=128 * br, stats=model_stats)
            assert torch.equal(got, want) and torch.equal(model, want), br
            assert stats == model_stats, (br, stats, model_stats)
            line.append(f"{br}: {stats['staged']} / {stats['fallback']}")
        log(f"[L.bsearch] {order}, {TUNE_PROBES} queries into A's root "
            f"prefix: equal to the plain version at every block_rows; tiles "
            f"staged / fell back (the model's the same) {'; '.join(line)}")

    # -- L.attention: every candidate at each head dim, both dtypes ---------
    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    errs, instances, oob_pre, oob_dec = {}, set(), 0, 0
    S, Sc = TUNE_SEQ, TUNE_CHECK_SEQ
    for D, (H, KV) in TUNE_WIDTHS.items():
        for dtype, tol_dec, tol_pre in ((bf16, BF16_TOL, BF16_TOL),
                                        (f32, F32_DECODE_TOL,
                                         F32_PREFILL_TOL)):
            if D not in pre_mod.HEAD_DIMS[dtype]:
                continue
            name = "bf16" if dtype == bf16 else "float32"
            q, k, v = (randn((2, H, D), dtype), randn((2, KV, S, D), dtype),
                       randn((2, KV, S, D), dtype))
            lens = torch.tensor([[S - 37], [S]], device=device)
            bias = torch.where(torch.arange(S, device=device)[None] < lens,
                               0.0, -1e30).to(f32)
            want = dec_mod.flash_decode_plain(q, k, v, bias)
            line = []
            for bs in autotune.KERNELS["flash_decode"].candidates:
                got = dec_mod.flash_decode(q, k, v, bias, block_s=bs)
                err = close(got, want, tol_dec)
                tk = dec_mod.decode_config(dtype, D, bs)["block_s"]
                instances.add(("flash_decode", name, D, tk))
                errs[("flash_decode", name, D, bs)] = err
                line.append(f"{bs} (stages of {tk}) {err:.3g}")
            log(f"[L.attention] flash_decode {name} D={D} H={H} KV={KV} "
                f"S={S}, max_abs_err by block_s: {'; '.join(line)} (rtol, "
                f"atol {tol_dec})")
            if on_card:
                # the checked build at every candidate, on the same ragged
                # operands: each instance's staged addressing
                for bs in autotune.KERNELS["flash_decode"].candidates:
                    oob = dec_mod.out_of_bounds(q, k, v, bias, block_s=bs)
                    assert oob["count"] == 0, (name, D, bs, oob)
                    close(oob["out"], want, tol_dec)
                    oob_dec += oob["count"]
                log(f"[L.attention] flash_decode_checked {name} D={D} S={S} "
                    f"at every candidate: 0 accesses outside the operands")
            q, k, v = (randn((1, H, S, D), dtype), randn((1, KV, S, D), dtype),
                       randn((1, KV, S, D), dtype))
            for causal in (True, False):
                want = pre_mod.flash_prefill_plain(q, k, v, causal)
                line = []
                for cand in autotune.KERNELS["flash_prefill"].candidates:
                    got = pre_mod.flash_prefill(q, k, v, causal, *cand)
                    err = close(got, want, tol_pre)
                    cfg = pre_mod.prefill_config(dtype, D, *cand)
                    inst = (cfg["block_q"], cfg["block_k"])
                    instances.add(("flash_prefill", name, D) + inst)
                    errs[("flash_prefill", name, D, causal, cand)] = err
                    line.append(f"{cand} ({inst}, {cfg['stages']} stages) "
                                f"{err:.3g}")
                log(f"[L.attention] flash_prefill {name} D={D} H={H} KV={KV} "
                    f"S={S} {'causal' if causal else 'full'}, max_abs_err by "
                    f"tile (instance): {'; '.join(line)} (rtol, atol "
                    f"{tol_pre})")
        if on_card and D in pre_mod.HEAD_DIMS[bf16]:
            q, k, v = (randn((1, H, Sc, D), bf16), randn((1, KV, Sc, D), bf16),
                       randn((1, KV, Sc, D), bf16))
            for cand in autotune.KERNELS["flash_prefill"].candidates:
                oob = pre_mod.out_of_bounds(q, k, v, True, *cand)
                assert oob["count"] == 0, (D, cand, oob)
                oob_pre += oob["count"]
            log(f"[L.attention] flash_prefill_tc_checked D={D} S={Sc} causal "
                f"at every candidate: 0 stores outside the operands")
    by_kernel = {}
    for inst in instances:
        by_kernel.setdefault((inst[0], inst[1]), set()).add(inst[2:])
    counts = {f"{k} {d}": len(v) for (k, d), v in sorted(by_kernel.items())}
    log(f"[L.attention] instances reached: {counts}")
    assert counts == {"flash_decode bf16": TUNE_INSTANCES["flash_decode"],
                      "flash_decode float32": 4,
                      "flash_prefill bf16": TUNE_INSTANCES["flash_prefill_tc"],
                      "flash_prefill float32":
                          TUNE_INSTANCES["flash_prefill"]}, counts
    out.update(attention_instances=counts,
               attention_max_abs_err={str(k): v for k, v in errs.items()},
               out_of_bounds={"tree_get_checked": oob_get,
                              "flash_prefill_tc_checked": oob_pre,
                              "flash_decode_checked": oob_dec})
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[L] {out['seconds']:.1f} s ({smi})")
    return out


def run_with_archs(args, device, kernel_policy=None) -> dict:
    """``run`` (phases A-L), then phase M once ``run``'s engines, indexes
    and data are released: the largest model needs the card's memory they
    hold; then phase N, and then the end of phase K's dry run, whose child
    runs on the host meanwhile (``join_dryrun``). Phases M's and N's
    launches, errors, instances and checked builds join the kernels
    line."""
    result = run(args, device, kernel_policy, defer_dryrun=True)
    kernels = result.pop("wrappers")
    held = result["end_to_end"]["lm"]["held_bytes"]
    parallel = result["end_to_end"]["parallel"]
    try:
        launches, e2e = run_archs(args, device, kernels, kernel_policy,
                                  held=held)
        launchesN, e2eN = run_reduced(args, device, kernels, kernel_policy)
    except BaseException:
        stop_child(parallel.pop("dryrun_pending")["child"])
        raise
    join_dryrun(parallel)
    result.update(archs=e2e, phase_m_launches=launches, reduced=e2eN,
                  phase_n_launches=launchesN)
    for row in result["kernels"]:
        name = row["name"]
        row["launches"] += launches.get(name, 0) + launchesN.get(name, 0)
        if row["tile"] is not None:
            row["tile"] = MAIN_TILES.get(name, {})
        for arch in list(e2e["archs"].values()) + list(
                e2eN["archs"].values()):
            err = arch.get("attention_errs", {}).get(name, 0.0)
            row["max_abs_err"] = max(row["max_abs_err"], err)
    # the checked builds of both phases; N's architectures by their
    # reduced names
    both = {"archs": dict(e2e["archs"], **{
        f"{a} (reduced)": r for a, r in e2eN["archs"].items()}),
        "checked": dict(e2e["checked"])}
    for name, runs in e2eN["checked"].items():
        both["checked"][name] = both["checked"].get(name, []) + runs
    result["kernels"] += checked_rows(both)
    return result


def run(args, device, kernel_policy=None, defer_dryrun=False) -> dict:
    """Phases A-L after the device check; ``main`` passes the card.
    (On the CPU, with ``KernelPolicy(prefer=True)``, the same control flow
    runs the plain versions: a rehearsal, with no launches to count.)
    ``defer_dryrun`` leaves K's dry-run child running for the caller's
    ``join_dryrun``."""
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
    from repro_torch.kernels.autotune import tile_for

    on_card = device.type == "cuda"
    MAIN_TILES.clear()
    CHECKED.clear()
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
        # the checked build of the draw (phase E's bounds checks) with them
        reports = build.build_all(build.SOURCES + tuple(build.VARIANTS))
        log(f"[build] {len(build.SOURCES)} kernels and "
            f"{len(build.VARIANTS)} checked build in "
            f"{time.perf_counter() - t0:.1f} s")
        for name in build.SOURCES:
            text = reports.get(name) or build.ptxas_report(name)
            for entry, line in ptxas_lines(text):
                log(f"[build] {name}: {entry}: {line}")
        # the draw's instances keep rows and locals in registers
        frames = [line for entry, line in ptxas_lines(
            reports.get("fused_draw") or build.ptxas_report("fused_draw"))
            if "fused_draw_kernel" in entry and "stack frame" in line]
        log(f"[build] fused_draw: {len(frames)} instances; stack frames and "
            f"spills: {sorted(set(frames))}")
        assert frames and all(line == "0 bytes stack frame, 0 bytes spill "
                              "stores, 0 bytes spill loads"
                              for line in frames), frames
        # the float scans' one launch, the caching walk and the float32
        # attention kernels: no frame either
        # and every instance of the tuned kernels (TUNE_INSTANCES: each
        # candidate tile at every tree size and head dim)
        for name, kernel in (("scan", "sc_fixed_kernel"),
                             ("csr_walk", "csr_walk_cached_kernel"),
                             ("flash_prefill", "flash_prefill_kernel"),
                             ("flash_decode", "flash_decode_f32_kernel"),
                             ("tree_get", "tree_get_kernel"),
                             ("bsearch_probe", "bsearch_probe_kernel"),
                             ("flash_decode", "flash_decode_tc_kernel"),
                             ("flash_prefill_tc", "flash_prefill_tc_kernel")):
            frames = [line for entry, line in ptxas_lines(
                reports.get(name) or build.ptxas_report(name))
                if kernel in entry and "stack frame" in line]
            log(f"[build] {name}: {len(frames)} {kernel} instances; stack "
                f"frames and spills: {sorted(set(frames))}")
            assert frames and all(line == "0 bytes stack frame, 0 bytes "
                                  "spill stores, 0 bytes spill loads"
                                  for line in frames), (kernel, frames)
            want = {"tree_get_kernel": "tree_get",
                    "bsearch_probe_kernel": "bsearch_probe",
                    "flash_decode_tc_kernel": "flash_decode",
                    "flash_prefill_tc_kernel": "flash_prefill_tc",
                    "flash_prefill_kernel": "flash_prefill"}.get(kernel)
            if want is not None:
                assert len(frames) == TUNE_INSTANCES[want], (name, kernel,
                                                            len(frames))
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

    def record(pref, qq, **kw):
        drawn.append((pref, qq.clone()))
        return bp_mod.bsearch_probe(pref, qq, **kw)

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
        if on_card:
            # the checked build on the same queries, at the main path's
            # tile; the tile counts' stores too, but in the call the row
            # repeats (the main path's, without them)
            br = tile_for("bsearch_probe", qq.numel(), kernel_policy, device)
            bounds_checked(
                "bsearch_probe_checked", "bsearch_probe",
                f"A, {name} ({qq.numel()} queries, block_rows {br}"
                f"{'' if name == 'sorted' else ', tile counts on'})",
                lambda: bp_mod.out_of_bounds(pref, qq, br,
                                             stats=name != "sorted"), want,
                row="bsearch_probe" if name == "sorted" else None)
        del got, want, model
    del probes_bs
    if on_card:
        # the checked GET over every position of A, and the checked bsearch
        # at ragged sizes: no access outside the operands
        brA = tile_for("tree_probe", nA, kernel_policy, device)
        bounds_checked("tree_get_checked", "tree_probe",
                       f"A, all {nA} positions (block_rows {brA})",
                       lambda: tp_mod.out_of_bounds(packA.arena, posA, layA,
                                                    block_rows=brA),
                       tp_mod.tree_probe_plain(packA.arena, posA, layA),
                       row="tree_probe")
        bsearch_bounds_ragged(prefA, qA, device, kernel_policy)
        assert_in_bounds("tree_get_checked", "bsearch_probe_checked")
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
            if on_card:
                # the per-page form's checked build, each launch against
                # its own page
                bounds_checked(
                    "tree_probe_paged_checked", "tree_probe_paged_pages",
                    f"{label}, {name} ({pos.numel()} probes)",
                    lambda: tp_mod.paged_out_of_bounds(pv, pos), want,
                    row=("tree_probe_paged_pages" if label == "C" and
                         name == "one draw's positions" else None))

    check_paged(pvC, "C")
    if on_card:
        paged_bounds_ragged(pvC, posS)
        assert_in_bounds("tree_probe_paged_checked")
        bounds_control = bounds_controls(device, pvC, posS[:1000])
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
    reset_counts(kernels)
    fullA = engA.full_join(q)
    zs = []
    mean, sd = planA.expected_k(), float(estimate.sample_std(planA.w, planA.p))
    for s in range(args.keys):
        smp = engA.sample(q, threefry.key(1000 + s))
        zs.append((check_sample(smp, fullA, "A") - mean) / sd)
    launchesA = launch_counts(kernels)
    log(f"[A] launches {launchesA}")
    log(f"[A] instances (tuned tiles) {window_tiles(kernels)}")
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
    reset_counts(kernels)
    fullB = engB.full_join(q)
    keysB = [threefry.key(2000 + s) for s in range(args.draws)]
    smpsB = [engB.sample(q, key) for key in keysB]
    counts = [check_sample(smp, fullB, "B") for smp in smpsB]
    launchesB = launch_counts(kernels)
    log(f"[B] launches {launchesB}")
    log(f"[B] instances (tuned tiles) {window_tiles(kernels)}")
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
    reset_counts(kernels)
    fullC = engC.full_join(q)
    keysC = [threefry.key(3000 + s) for s in range(args.draws)]
    smpsC = [engC.sample(q, key) for key in keysC]
    counts = [check_sample(smp, fullC, "C") for smp in smpsC]
    launchesC = launch_counts(kernels)
    log(f"[C] launches {launchesC}")
    log(f"[C] instances (tuned tiles) {window_tiles(kernels)}")
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
    reset_counts(kernels)
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
    launchesR = launch_counts(kernels)
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
    if on_card:
        assert_in_bounds("tree_probe_paged_checked")

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
    # -- 7f. phase I: LM serving
    launchesI, e2eI = run_lm(args, device, kernels, kernel_policy)
    e2e["lm"] = e2eI
    for name, err in e2eI["attention_errs"].items():
        errs[name] = max(errs[name], err)
    if on_card:
        log(f"[memory] after phase I: "
            f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB held")
    # -- 7g. phase J: LM training
    launchesJ, e2eJ = run_training(args, device, kernels, kernel_policy)
    e2e["training"] = e2eJ
    if on_card:
        log(f"[memory] after phase J: "
            f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB held")
    # -- 7h. phase K: data parallelism, compression, GPipe, the dry run
    launchesK, e2eK = run_parallel(args, device, kernels,
                                   defer_dryrun=defer_dryrun)
    e2e["parallel"] = e2eK
    if on_card:
        log(f"[memory] after phase K: "
            f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB held")
    # -- 7i. phase L: tuning (the sweep and every candidate instance), after
    # the main path's windows: its launches count in none of them
    e2e["tuning"] = run_tuning(
        args, device, nvidia_smi_line() if on_card else "cpu", prefA, packA,
        nA)
    if on_card:
        log(f"[memory] after phase L: "
            f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB held")
    for k in kernels:
        launches[k] = (launchesA[k] + launchesB[k] + launchesC[k]
                       + launchesR[k] + launchesD[k]
                       + sum(lp[k] for lp in launchesE.values())
                       + sum(lp[k] for lp in launchesF.values())
                       + sum(lp[k] for lp in launchesG.values())
                       + sum(lp[k] for lp in launchesH.values())
                       + launchesI[k] + launchesJ[k] + launchesK[k])

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
    # the tuned kernels' launches by instance on the main path
    tuned = {k for k, f in kernels.items() if hasattr(f, "tiles")}
    log(f"[tiles] the main path's instances: {MAIN_TILES}")
    table = []
    for name, replaces, source, ms, plain_ms, b_ms, b_by, lib_ms in rows + rowsD:
        table.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "tile": (MAIN_TILES.get(name, {}) if name in tuned else None)})
        dms = (f"; device {dev_ms[name][0]:.4f} ms in "
               f"{dev_ms[name][1]:g} operations a call"
               if name in dev_ms else "")
        log(f"[time] {name}: {ms:.4f} ms (plain {plain_ms:.3f}, bound "
            f"{b_ms:.4f} by {b_by}"
            + (f", library {lib_ms:.4f}" if lib_ms is not None else "")
            + f"){dms}")
    # the checked builds of phases A-F beside the rows whose calls they repeat
    table += checked_build_rows(table)
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
            "bsearch_tiles_A": tiles_bs, "checked_builds": dict(CHECKED),
            "checked_controls": bounds_control if on_card else {},
            "phase_e_launches": launchesE,
            "phase_f_launches": launchesF,
            "phase_g_launches": launchesG,
            "phase_h_launches": launchesH,
            "phase_i_launches": launchesI,
            "phase_j_launches": launchesJ,
            "phase_k_launches": launchesK, "wrappers": kernels,
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
    ap.add_argument("--lm-requests", type=int, default=8,
                    help="requests of phase I's smollm-135m serving")
    ap.add_argument("--lm-prompt-min", type=int, default=128,
                    help="fewest prompt tokens of a phase I request")
    ap.add_argument("--lm-prompt-max", type=int, default=1024,
                    help="most prompt tokens of a phase I request")
    ap.add_argument("--lm-new", type=int, default=32,
                    help="new tokens a phase I request")
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
    # phase J trains under deterministic algorithms: cuBLAS reads this
    # before its first call, which earlier phases make
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
    result = run_with_archs(args, device)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(result, device=smi), indent=1))
    print("ARCHS " + json.dumps(archs_summary(result["archs"])))
    print("REDUCED " + json.dumps(reduced_summary(result["reduced"])))
    print("TRAINING " + json.dumps(training_summary(
        result["end_to_end"]["training"])))
    print("PARALLEL " + json.dumps(parallel_summary(
        result["end_to_end"]["parallel"])))
    print(smi)
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
