"""Multi-pod dry run (``repro.launch.dryrun``): for every (architecture x
input shape) cell and both production meshes (16 x 16 and 2 x 16 x 16,
``mesh.make_production_mesh``, every entry on ``meta``), what one device
holds and what the step computes. Records land in
``experiments/dryrun/*.json``.

    python -m repro_torch.launch.dryrun --arch smollm_135m --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod | --single-pod |
                                             --both]
    python -m repro_torch.launch.dryrun --paper [--device cpu]

(with ``PYTHONPATH=src``). A cell's record:

  * **per-device bytes** of the parameters, the AdamW state, the batch and
    the decode cache, from the reference's sharding rules: the parameters'
    specs (``layers.param_specs``, ``sanitize_pspecs``) on the reference's
    stacked leaves (``convert.reference_path``), the moments in bf16 for
    bf16 parameters and the factored second moment of ``opt_factored``
    (its row and column factors of every leaf of two or more dimensions,
    a stacked vector included, as the reference's ``adamw_init`` makes
    them), ``batch_shardings`` (the batch on the data axes when it
    divides) and ``cache_shardings`` (batch on the data axes; the model
    axis on KV heads, else the cache's sequence, else head dim). Their sum
    against the H100's 80 GB: the resident state only (no compiler here
    reports activations, gradients or temporaries); and the same state on
    one card alone (``one_card``);
  * **the step's FLOPs**, counted by ``torch.utils.flop_counter.
    FlopCounterMode`` over the step on ``meta`` tensors (the model built
    on ``meta``, nothing drawn or allocated), through the plain attention
    routes (``KernelPolicy(enabled=False)``: a ctypes launch cannot run
    on ``meta``), ``remat``'s recomputation and ``grad_accum``'s
    microbatches included. A full-size step is millions of ``meta``
    operations (one costs ~30 us, ~200 us under the counter, and the plain
    attention loops over batch rows and KV heads), so the counted step is
    cut and scaled, exactly: FLOPs add over the pattern's repeats beyond
    two (one repeat, then two, gives a repeat's share: a repeat is
    ``remat``'s checkpoint, whose recomputation stops after the last tensor
    the backward needs, so its share is counted whole) and over the
    encoder's layers beyond two, over a microbatch's rows (counted at the fewest rows whose MoE
    capacity, a multiple of 128 slots, scales to the microbatch's) and,
    for RWKV (no attention, every operation per token), over the sequence
    (counted at ``RWKV_SEQ`` tokens). Decode steps are counted at the
    full batch.
    ``main`` counts the cells in worker processes, one a core. Recorded
    as the total, the total over the chips, and ``6 N_active tokens``
    beside them, as the reference does;
  * **collective bytes**: a device's bytes of each of the reference's
    five collective types (``collective_bytes``; all-reduce counted
    twice) and their total (``collective_total_bytes``), counted by
    ``launch/comm_cost.py`` over the step run on ``meta`` DTensors on the
    cell's mesh (the port's counterpart of the reference's HLO count,
    ``launch/hlo_cost.py``). Cut and scaled as the FLOPs are, exactly:
    over the repeats beyond two and the encoder's layers beyond two, and
    for RWKV (its token loop) over the sequence, counted at
    ``RWKV_COUNT_SEQ`` tokens and twice that, affine in the tokens (at 32
    DTensor chose a layout that 64 and more do not). The rows are counted
    in full: no DTensor operation loops over them, so the count costs the
    same at any batch, and DTensor's layouts depend on the sizes
    (``step_collectives``). DTensor chooses its own layouts between the
    reference's constraints, and they change between torch versions, so a
    record names the version (``collectives_counted.torch``). Held against
    the reference's ``HloCost`` of the same step on a (4, 2) mesh
    (``tests/test_torch_dryrun_collectives.py``, reduced configs, B 8,
    S 64): dense train and prefill come to 1.01x and 0.79x of it; the MoE
    layers (the dispatch gathers every token, gate and contribution to
    every device) and decode steps (every weight gathered over the data
    axes at its use) come to 1.5x-2.4x. Read those as the counting
    route's upper bounds (``collectives_counted.upper_bound``), not as
    what a partitioner must move;
  * **a roofline** from the H100's own constants (``PEAK_FLOPS``,
    ``HBM_BW``, ``LINK_BW``): compute seconds (a device's FLOPs at the
    bf16 peak), memory seconds (a device's resident bytes read once: a
    lower bound) and collective seconds (a device's collective bytes over
    one direction of NVLink), and the ``dominant`` of the three.

``compat.py`` (jax version shims) is not ported: the port has no jax.

``--paper`` (``run_paper_cell``): the paper's own pipeline, the port's
``ShardedPoissonSampler`` on the EpiQL-like contact query at ``scale``
persons, root block-partitioned over a mesh of the production data
axis's entries (16, or 2 x 16) on the card: peak device memory, one warm
draw's time, ``per_shard_capacity`` and, as ``collective_total_bytes``,
the bytes a warm draw's gather moves from the other entries to the
engine's (``ShardedPlan._gather``), where the reference only compiles.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.config import KernelPolicy, resolve_device
from repro_torch.launch.comm_cost import COLLECTIVES, count_collectives
from repro_torch.launch.mesh import batch_axes, make_mesh, make_production_mesh
from repro_torch.models import convert, layers, transformer
from repro_torch.models.layers import P, PartitionSpec
from repro_torch.models.moe import capacity
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

__all__ = ["OUT_DIR", "PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "LINK_BW",
           "batch_shardings", "cache_shardings", "reference_leaves",
           "state_bytes", "make_train_step", "make_prefill",
           "make_serve_step", "step_flops", "step_collectives",
           "count_cells", "run_cell", "gather_bytes", "run_paper_cell",
           "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun"

# NVIDIA H100 SXM (data sheet; dense, at its 700 W limit)
PEAK_FLOPS = 989e12      # bf16 tensor cores, FLOP/s
HBM_BW = 3.35e12         # HBM3, bytes/s
HBM_BYTES = 80e9         # HBM3 capacity
# NVLink 4 of the H100 SXM, one direction (data sheet: 900 GB/s both ways
# to the other cards of a host). An axis that spans hosts runs at the
# InfiniBand rate instead (a 400 Gb/s port: 50 GB/s a card), 9 times
# slower: the collective seconds are a lower bound.
LINK_BW = 450e9          # bytes/s

RWKV_SEQ = 32            # an RWKV step's counted tokens (scaled to S)
RWKV_COUNT_SEQ = 64      # ... for its collectives, and twice that
PLAIN = KernelPolicy(enabled=False)


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------

def _dp_spec(mesh, size: int) -> PartitionSpec:
    """The batch's leading entry: the data axes when ``size`` divides."""
    dp = batch_axes(mesh)
    total = int(np.prod([mesh.shape[a] for a in dp]))
    return P(dp) if dp and size % total == 0 else P(None)


def batch_shardings(mesh, specs: Dict[str, torch.Tensor]
                    ) -> Dict[str, PartitionSpec]:
    """Each input's spec: batch on the data axes when it divides, the rest
    replicated; a 0-d input replicated."""
    return {k: P() if v.ndim == 0 else
            P(*(tuple(_dp_spec(mesh, v.shape[0])) + (None,) * (v.ndim - 1)))
            for k, v in specs.items()}


def cache_shardings(mesh, cfg, cache) -> List[Dict[str, PartitionSpec]]:
    """The reference's decode-cache rules on the port's per-layer cache:
    batch on the data axes; the model axis on the KV heads when they
    divide, else on the cache's sequence when it divides and holds 4,096
    or more, else on head dim (K and V are (B, KV, T, hd) here, (R, B, T,
    KV, hd) there); on the state's heads, the conv's channels and the
    shifts' features when they divide."""
    m = mesh.shape["model"]
    out = []
    for layer in cache:
        specs = {}
        for name, v in layer.items():
            dims = [None] * v.ndim
            if v.ndim >= 1:
                dp = tuple(_dp_spec(mesh, v.shape[0]))
                dims[0] = dp[0] if dp != (None,) else None
            if name in ("k", "v", "ck", "cv") and v.ndim == 4:
                if v.shape[1] % m == 0:
                    dims[1] = "model"            # KV heads
                elif v.shape[2] % m == 0 and v.shape[2] >= 4096:
                    dims[2] = "model"            # the cache's sequence
                elif v.shape[3] % m == 0:
                    dims[3] = "model"            # head dim
            elif name == "state" and v.ndim >= 3:
                if v.shape[1] % m == 0:
                    dims[1] = "model"            # state heads
            elif name == "conv" and v.ndim == 3 and v.shape[2] % m == 0:
                dims[2] = "model"
            elif name in ("shift_t", "shift_c") and v.ndim == 2 \
                    and v.shape[1] % m == 0:
                dims[1] = "model"
            specs[name] = P(*dims)
        out.append(specs)
    return out


def reference_leaves(model) -> Dict[str, tuple]:
    """The reference's parameter leaves of ``model``: {path: (shape, dtype,
    stacked)}, each stacked leaf with its repeat axis first."""
    P_len = len(model.cfg.pattern)
    leaves: Dict[str, list] = {}
    for name, p in model.named_parameters():
        path, stacked = convert.reference_path(name, P_len)
        key = "/" + "/".join(path)
        if key in leaves:
            leaves[key][3] += 1
        else:
            leaves[key] = [tuple(p.shape), p.dtype, stacked, 1]
    return {k: ((n,) + shape if stacked else shape, dt, stacked)
            for k, (shape, dt, stacked, n) in leaves.items()}


def _device_bytes(shape, dtype: torch.dtype, spec, mesh) -> int:
    """A device's bytes of a tensor of ``shape`` under ``spec``."""
    block = layers.NamedSharding(mesh, spec).shard_shape(shape)
    return int(np.prod(block)) * torch.empty((), dtype=dtype).element_size()


def state_bytes(model, mesh, kind: str, specs: Dict[str, torch.Tensor],
                cache=None) -> Dict[str, int]:
    """A device's bytes of the parameters, the AdamW state (train), the
    batch and the decode cache (decode) under the reference's rules."""
    cfg = model.cfg
    leaves = reference_leaves(model)
    shapes = {k: s for k, (s, _, _) in leaves.items()}
    pspecs = layers.sanitize_pspecs(
        {k: layers.spec_for_path(k, len(s), st)
         for k, (s, _, st) in leaves.items()}, shapes, mesh)
    out = {"params": sum(_device_bytes(s, dt, pspecs[k], mesh)
                         for k, (s, dt, _) in leaves.items())}
    if kind == "train":
        mdt = torch.bfloat16 if cfg.param_dtype == "bfloat16" \
            else torch.float32
        opt = 4  # the step counter, int32
        for k, (s, _, _) in leaves.items():
            sp = list(pspecs[k]) + [None] * (len(s) - len(pspecs[k]))
            opt += _device_bytes(s, mdt, sp, mesh)                   # m
            if cfg.opt_factored and len(s) >= 2:                     # v
                opt += _device_bytes(s[:-1], mdt, sp[:-1], mesh)
                opt += _device_bytes(s[:-2] + s[-1:], mdt,
                                     sp[:-2] + sp[-1:], mesh)
            else:
                opt += _device_bytes(s, mdt, sp, mesh)
        out["opt"] = opt
    bspecs = batch_shardings(mesh, specs)
    out["batch"] = sum(_device_bytes(tuple(v.shape), v.dtype, bspecs[k], mesh)
                       for k, v in specs.items())
    if cache is not None:
        cspecs = cache_shardings(mesh, cfg, cache)
        out["cache"] = sum(_device_bytes(tuple(v.shape), v.dtype, sp[k], mesh)
                           for layer, sp in zip(cache, cspecs)
                           for k, v in layer.items())
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step(cfg, opt_cfg: AdamWConfig):
    """The full training step over ``(model, opt_state, batch)``; with
    ``cfg.grad_accum`` > 1 the batch is split into that many sequential
    microbatches whose gradients are summed in the parameters' dtype and
    divided by their count, as the reference's step does."""
    accum = max(cfg.grad_accum, 1)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        if accum == 1:
            loss, _ = transformer.loss_fn(model, batch)
            loss.backward()
        else:
            micro = [{k: v.chunk(accum)[i] for k, v in batch.items()}
                     for i in range(accum)]
            loss = 0.0
            for mb in micro:
                part, _ = transformer.loss_fn(model, mb)
                part.backward()
                loss = loss + part.detach()
            loss = loss / accum
        grads = {n: torch.zeros_like(p) if p.grad is None
                 else p.grad / accum for n, p in params.items()}
        _, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step


def make_prefill(cfg):
    def prefill_step(model, batch):
        with torch.no_grad():
            memory = batch.get("memory")
            if cfg.has_encoder:
                memory = transformer.encode(model, batch["frames"])
            logits, _ = transformer.forward(model, batch["tokens"], memory)
        return logits[:, -1]

    return prefill_step


def make_serve_step(cfg):
    def serve_step(model, cache, tokens, cur: int):
        with torch.no_grad():
            return transformer.decode_step(model, cache, tokens, cur)

    return serve_step


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def _inputs(cfg, kind: str, B: int, S: int) -> Dict[str, torch.Tensor]:
    """``configs.input_specs``' meta tensors at batch ``B`` and sequence
    ``S`` (decode: the new token only)."""
    specs = configs.input_specs(cfg, {"train": "train_4k",
                                      "prefill": "prefill_32k",
                                      "decode": "decode_32k"}[kind])
    out = {}
    for k, v in specs.items():
        if v.ndim == 0:
            continue
        tail = (S,) if k in ("tokens", "targets") and kind != "decode" \
            else tuple(v.shape[1:])
        out[k] = torch.empty((B,) + tail, dtype=v.dtype, device="meta")
    return out


def _counted(cfg, kind: str, B: int, S: int, cache_len: int) -> int:
    """FLOPs of one step of ``cfg`` at batch ``B`` and sequence ``S`` on
    ``meta``, counted in full."""
    model = transformer.init_model(cfg, device="meta", policy=PLAIN)
    batch = _inputs(cfg, kind, B, S)
    with FlopCounterMode(display=False) as counter:
        if kind == "train":
            opt_cfg = AdamWConfig(
                moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
                else "float32", factored=cfg.opt_factored)
            make_train_step(cfg, opt_cfg)(
                model, adamw_init(opt_cfg, dict(model.named_parameters())),
                batch)
        elif kind == "prefill":
            make_prefill(cfg)(model, batch)
        else:
            cache = transformer.init_cache(cfg, B, cache_len,
                                           cfg.n_memory_tokens, device="meta")
            make_serve_step(cfg)(model, cache, batch["tokens"], cache_len - 1)
    return int(counter.get_total_flops())


def _rows(cfg, micro: int, S: int) -> int:
    """The fewest rows of a microbatch of ``micro`` rows whose count scales
    to it exactly: 1, or for an MoE model the first divisor whose
    capacity times the microbatches of that size is the microbatch's."""
    if not cfg.is_moe:
        return 1
    for r in range(1, micro + 1):
        if micro % r == 0 and \
                capacity(r * S, cfg) * (micro // r) == capacity(micro * S,
                                                                cfg):
            return r
    return micro


def step_flops(cfg, kind: str, B: int, S: int) -> Dict:
    """A step's FLOPs at batch ``B`` and sequence ``S`` (decode: a cache of
    ``S``), counted on a cut step and scaled (the module docstring):
    ``{"flops", "rows", "seq", "runs", "seconds"}``, the counted rows
    (each microbatch's), the counted sequence, the configurations counted
    and the count's seconds."""
    accum = max(cfg.grad_accum, 1) if kind == "train" else 1
    if kind == "decode":
        rows, seq, scale = B, 1, 1.0
    else:
        rows = accum * _rows(cfg, B // accum, S)
        seq = min(S, RWKV_SEQ) if set(cfg.pattern) == {"rwkv"} else S
        scale = (B / rows) * (S / seq)
    t0 = time.perf_counter()
    P_len = len(cfg.pattern)
    # depths counted: the full one up to two repeats (encoder layers), else
    # one and two, extrapolated
    R, E = cfg.repeats, cfg.enc_layers
    r0, e0 = (1 if R > 2 else R), (1 if E > 2 else E)

    def count(r, e):
        return _counted(dataclasses.replace(cfg, n_layers=r * P_len,
                                            enc_layers=e), kind, rows, seq, S)

    base = count(r0, e0)
    total = float(base)
    runs = 1
    if r0 != R:
        total += (R - r0) * (count(r0 + 1, e0) - base)
        runs += 1
    if e0 != E:
        total += (E - e0) * (count(r0, e0 + 1) - base)
        runs += 1
    return {"flops": total * scale, "rows": rows, "seq": seq, "runs": runs,
            "seconds": time.perf_counter() - t0}


def step_collectives(cfg, kind: str, B: int, S: int, mesh) -> Dict:
    """A step's collective bytes on ``mesh`` (a production mesh, its shape
    and axis names) at batch ``B`` and sequence ``S`` (decode: a cache of
    ``S``), counted by ``comm_cost.count_collectives`` on a cut step and
    scaled as ``step_flops`` scales (the module docstring): ``{"bytes":
    {type: a device's bytes}, "seq", "runs", "seconds"}``. The batch
    takes the data axes when ``B`` >= 32, as ``run_cell`` sets them."""
    t0 = time.perf_counter()
    layers.set_batch_axes(batch_axes(mesh) if B >= 32 else ())
    layers.set_moe_ep(getattr(cfg, "moe_ep", False))
    P_len = len(cfg.pattern)
    R, E = cfg.repeats, cfg.enc_layers
    r0, e0 = (1 if R > 2 else R), (1 if E > 2 else E)
    seq = S
    if kind != "decode" and set(cfg.pattern) == {"rwkv"}:
        seq = min(S, RWKV_COUNT_SEQ)
    runs = 0

    def count(r, e, s):
        nonlocal runs
        runs += 1
        return count_collectives(
            dataclasses.replace(cfg, n_layers=r * P_len, enc_layers=e),
            kind, B, s, mesh)["bytes"]

    def total(s):
        base = count(r0, e0, s)
        out = {k: float(v) for k, v in base.items()}
        for extra, (r, e) in ((R - r0, (r0 + 1, e0)),
                              (E - e0, (r0, e0 + 1))):
            if extra:
                more = count(r, e, s)
                for k in out:
                    out[k] += extra * (more[k] - base[k])
        return out

    got = total(seq)
    if seq != S:  # affine in the tokens: counted at seq and 2 seq
        twice = total(2 * seq)
        got = {k: got[k] + (S / seq - 1) * (twice[k] - got[k]) for k in got}
    return {"bytes": got, "seq": seq, "runs": runs,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _write(tag: str, rec: Dict, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{tag}.json", "w") as f:
        json.dump(rec, f, indent=2)


def run_cell(arch: str, shape: str, multi_pod: bool, verbose: bool = True,
             flops_cache: Optional[Dict] = None,
             out_dir: Path = OUT_DIR,
             collectives_cache: Optional[Dict] = None) -> Dict:
    """One (arch x shape) cell on one production mesh: its record (a skip
    record where ``configs.shape_applicable`` rejects the cell), also
    written to ``out_dir``. ``flops_cache`` keeps a cell's count for the
    other mesh (the count does not depend on the mesh);
    ``collectives_cache`` holds counts made elsewhere (``count_cells``),
    by (arch, shape, multi_pod)."""
    cfg = configs.get_config(arch)
    skip = configs.shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape}__{mesh_name}"
    if skip:
        rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "skipped": skip}
        _write(tag, rec, out_dir)
        if verbose:
            print(f"[dryrun] SKIP {tag}: {skip}")
        return rec

    sp = configs.SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    layers.set_batch_axes(batch_axes(mesh) if sp.batch >= 32 else ())
    layers.set_moe_ep(getattr(cfg, "moe_ep", False))
    n_chips = mesh.size
    specs = configs.input_specs(cfg, shape)
    model = transformer.init_model(cfg, device="meta", policy=PLAIN)
    cache = (transformer.init_cache(cfg, sp.batch, sp.seq,
                                    cfg.n_memory_tokens, device="meta")
             if sp.kind == "decode" else None)
    mem = state_bytes(model, mesh, sp.kind, specs, cache)
    one = state_bytes(model, make_mesh((1, 1), ("data", "model"),
                                       devices="meta"), sp.kind, specs, cache)
    key = (arch, shape)
    if flops_cache is not None and key in flops_cache:
        counted = flops_cache[key]
    else:
        counted = step_flops(cfg, sp.kind, sp.batch, sp.seq)
        if flops_cache is not None:
            flops_cache[key] = counted
    ckey = (arch, shape, multi_pod)
    if collectives_cache is not None and ckey in collectives_cache:
        coll = collectives_cache[ckey]
    else:
        coll = step_collectives(cfg, sp.kind, sp.batch, sp.seq, mesh)
    layers.set_batch_axes(batch_axes(mesh) if sp.batch >= 32 else ())
    coll_total = sum(coll["bytes"].values())
    flops = counted["flops"]
    per_dev = flops / n_chips
    t_compute = per_dev / PEAK_FLOPS
    t_memory = mem["total"] / HBM_BW
    t_coll = coll_total / LINK_BW
    ntok = sp.batch * (1 if sp.kind == "decode" else sp.seq)
    model_flops = 6 * cfg.active_param_count() * ntok
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": n_chips,
        "kind": sp.kind, "seq": sp.seq, "batch": sp.batch,
        "count_s": round(counted["seconds"], 2),
        "collective_count_s": round(coll["seconds"], 2),
        "memory_per_device": mem,
        "fits_80gb": mem["total"] <= HBM_BYTES,
        "one_card": {"total": one["total"],
                     "fits_80gb": one["total"] <= HBM_BYTES},
        "flops_total": flops,
        "flops_per_device": per_dev,
        "flops_counted": {k: counted[k] for k in ("rows", "seq", "runs")},
        "collective_bytes": {k: coll["bytes"][k] for k in COLLECTIVES},
        "collective_total_bytes": coll_total,
        "collectives_counted": {
            **{k: coll[k] for k in ("seq", "runs")},
            # DTensor's layouts, so the bytes, differ between versions
            "torch": torch.__version__,
            "upper_bound": sp.kind == "decode" or bool(cfg.n_experts)},
        "roofline": {
            "compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_coll,
            "dominant": max((("compute", t_compute), ("memory", t_memory),
                             ("collective", t_coll)),
                            key=lambda kv: kv[1])[0],
            "peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
            "link_bytes_per_s": LINK_BW},
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / n_chips,
        "useful_flops_ratio": model_flops / flops if flops else None,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }
    _write(tag, rec, out_dir)
    if verbose:
        print(f"[dryrun] {tag}: {mem['total'] / 2**30:.3f} GiB a device "
              f"({'fits' if rec['fits_80gb'] else 'does not fit'} 80 GB; "
              + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in mem.items()
                          if k != "total")
              + f"; one card alone {one['total'] / 2**30:.1f} GiB), FLOPs "
              f"{flops:.4e} ({per_dev:.4e} a device, 6ND "
              f"{model_flops:.4e}), compute {t_compute:.4g} s, memory "
              f"{t_memory:.4g} s, collective {t_coll:.4g} s "
              f"({coll_total:.4e} bytes a device; dominant "
              f"{rec['roofline']['dominant']}); counted in "
              f"{counted['seconds']:.1f} s and {coll['seconds']:.1f} s")
    return rec


def gather_bytes(shards) -> int:
    """The bytes ``ShardedPlan._gather`` moves between entries for one
    draw of ``shards`` (the shards' samples, shard i on entry i): every
    buffer of every shard but shard 0, whose entry is the engine's (its
    count, columns, positions and overflow, whole: the compaction moves
    the buffers, not the valid lanes)."""
    return sum(t.numel() * t.element_size() for s in shards[1:]
               for t in (s.count, s.positions, s.overflow,
                         *s.columns.values()))


def run_paper_cell(multi_pod: bool, scale: int = 200_000, device=None,
                   seed: int = 0, out_dir: Path = OUT_DIR) -> Dict:
    """The paper's own pipeline: the sharded Poisson sampler on the
    production mesh's data axis (16 entries, or 2 x 16 for two pods), every
    entry on ``device`` (the card by default), over an EpiQL-like contact
    query (``Q_c``: a star join of ``ContactProb`` with two ``Person``
    aliases) at ``scale`` persons. Records the index's build, peak device
    memory, one warm draw's time, ``per_shard_capacity`` and the bytes
    that draw's gather moves between entries (``gather_bytes``, as
    ``collective_total_bytes``)."""
    from repro_torch.core import Atom, Database, JoinQuery
    from repro_torch.core.distributed import ShardedPoissonSampler
    from repro_torch.kernels import threefry

    device = resolve_device(device)
    on_card = device.type == "cuda"
    shape = (2, 16) if multi_pod else (16,)
    axes = ("pod", "data") if multi_pod else ("data",)
    mesh = make_mesh(shape, axes, devices=device)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rng = np.random.default_rng(seed)
    npool, nage, npers = max(scale // 50, 4), 6, scale
    grid_n = npool * nage * nage
    db = Database.from_columns({
        "Person": {"pers": np.arange(npers),
                   "age": rng.integers(0, nage, npers),
                   "pool": rng.integers(0, npool, npers)},
        "ContactProb": {"pool": rng.integers(0, npool, grid_n),
                        "age1": rng.integers(0, nage, grid_n),
                        "age2": rng.integers(0, nage, grid_n),
                        "prob": rng.random(grid_n) * 0.05},
    }, device=device)
    q = JoinQuery((
        Atom.of("ContactProb", "pool", "age1", "age2", "prob"),
        Atom.of("Person", "per1", "age1", "pool", alias="P1"),
        Atom.of("Person", "per2", "age2", "pool", alias="P2"),
    ), prob_var="prob")

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    if on_card:
        sync()
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    s = ShardedPoissonSampler(db, q, mesh, axes=axes)
    sync()
    build_s = time.perf_counter() - t0
    shards, count = s.sample_step(threefry.key(seed))   # warm
    sync()
    t0 = time.perf_counter()
    shards, count = s.sample_step(threefry.key(seed + 1))
    sync()
    draw_ms = (time.perf_counter() - t0) * 1e3
    rec = {
        "arch": "paper_qc_sampler", "shape": f"scale_{scale}",
        "mesh": mesh_name, "kind": "sample_step", "entries": mesh.size,
        "device": str(device), "build_s": build_s,
        "join_size": int(s._plan.join_size), "sample_count": int(count),
        "draw_ms": draw_ms,
        "peak_device_bytes": (int(torch.cuda.max_memory_allocated(device))
                              - held if on_card else None),
        "per_shard_capacity": int(s.cap),
        "collective_total_bytes": gather_bytes(shards),
    }
    _write(f"paper_qc_sampler__scale{scale}__{mesh_name}", rec, out_dir)
    print(f"[dryrun] paper sampler {mesh_name} on {device}: {mesh.size} "
          f"shards, join {rec['join_size']}, build {build_s:.2f} s, a draw "
          f"{draw_ms:.3f} ms ({rec['sample_count']} tuples), peak "
          + ("not measured" if rec["peak_device_bytes"] is None else
             f"{rec['peak_device_bytes'] / 2**30:.3f} GiB")
          + f", per-shard capacity {rec['per_shard_capacity']}, its gather "
          f"{rec['collective_total_bytes']:,} bytes between entries")
    return rec


def count_cells(cells, meshes=(False, True)) -> tuple:
    """``step_flops`` of each (arch, shape) of ``cells`` that
    ``configs.shape_applicable`` runs, and its ``step_collectives`` on
    each mesh of ``meshes`` (``multi_pod`` flags), in spawned worker
    processes, one a core, the slowest first: ({(arch, shape): its
    count}, {(arch, shape, multi_pod): its collectives})."""
    cells = [(a, s) for a, s in cells
             if not configs.shape_applicable(configs.get_config(a), s)]
    if not cells:
        return {}, {}
    jobs = [(step_collectives, (a, s, mp)) for a, s in cells
            for mp in meshes] + [(step_flops, (a, s)) for a, s in cells]
    on = {mp: make_production_mesh(multi_pod=mp) for mp in meshes}
    # the train steps' counts first: they take the longest
    jobs.sort(key=lambda j: configs.SHAPES[j[1][1]].kind != "train")
    workers = min(len(jobs), os.cpu_count() or 1)
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=get_context("spawn")) as pool:
        futures = {}
        for fn, key in jobs:
            sp = configs.SHAPES[key[1]]
            futures[(fn, key)] = pool.submit(
                fn, configs.get_config(key[0]), sp.kind, sp.batch, sp.seq,
                *(on[mp] for mp in key[2:]))
        flops, colls = {}, {}
        for (fn, key), f in futures.items():
            (flops if fn is step_flops else colls)[key] = f.result()
        return flops, colls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 only")
    ap.add_argument("--single-pod", action="store_true", help="16x16 only")
    ap.add_argument("--both", action="store_true",
                    help="both meshes (the default), as the reference's "
                         "flag")
    ap.add_argument("--paper", action="store_true",
                    help="run the paper's sharded Poisson sampler")
    ap.add_argument("--device", default=None,
                    help="the paper cell's device (default: the card)")
    args = ap.parse_args(argv)

    if args.paper:
        run_paper_cell(multi_pod=False, device=args.device)
        run_paper_cell(multi_pod=True, device=args.device)
        if not (args.all or args.arch):
            return 0

    if args.multi_pod:
        meshes = [True]
    elif args.single_pod:
        meshes = [False]
    else:
        meshes = [False, True]
    archs = list(configs.ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(configs.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    flops_cache, colls = count_cells([(a, s) for a in archs for s in shapes],
                                     meshes)
    failures = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                try:
                    run_cell(a, s, mp, flops_cache=flops_cache,
                             collectives_cache=colls)
                except Exception as e:  # noqa: BLE001 — report all at the end
                    failures.append((a, s, mp, repr(e)[:300]))
                    print(f"[dryrun] FAIL {a} {s} multi_pod={mp}: {e}",
                          file=sys.stderr)
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\n[dryrun] all cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
