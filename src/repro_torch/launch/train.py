"""Training (``repro.launch.train``): the fault-tolerant loop with
checkpoint/resume, the straggler watchdog, elastic data parallelism, and
the Poisson-join data pipeline.

    python -m repro_torch.launch.train [--steps 20]
    python -m repro_torch.launch.train --full --seq-len 2048 --batch 8 \
        [--devices 4]

(with ``PYTHONPATH=src``; the card by default, ``--device cpu`` runs here).
Without ``--full`` it trains the reduced config (head dim 16, float32: the
float32 prefill kernel's D 16 instance on the card), as the reference's
default does; ``--full`` trains the published one.

Elastic mesh, as the reference's: the data-parallel degree is re-derived
from the mesh's entries at every (re)start (``TrainConfig.devices``:
every visible card by default; a list may repeat a card, as a mesh of four
entries on one card does). The batch is split over the mesh's data axes
when the mesh has more than one entry and the global batch divides
(``layers.set_batch_axes``), else the step runs on the first entry. A
data-parallel step (``dp_train_step``) holds a replica of the model on
each entry, splits the global batch over the entries in the mesh's shard
order, runs each share's forward and backward on its replica, sums the
gradients into the first entry in that order, applies one AdamW update
there and copies the parameters to every replica, which then hold the
same bits. It computes the gradient of the global batch's loss, as the
reference's GSPMD step does: each share's loss divides by the global
batch's count of counted tokens, and an MoE model first routes every
share (without a gradient) to combine the shares' router statistics (the
capacity's slots and the aux loss's expert density) before the step's
forward pass (``moe.Dispatch``). The batch stream depends only on (seed,
step, schedule), never on the mesh, so a restart on another mesh resumes
the same stream; resume is bit for bit on a fixed mesh.

The reference's int8 gradient compression (``parallel/compress.py``) has
no flag in its ``train`` (its docstring promises an opt-in one): the port
adds none either.

Fault tolerance, as the reference's:
  * checkpoints: atomic, checksummed, keep-N, asynchronous; ``train``
    resumes from the newest valid step, so a node failure is a restart;
  * straggler watchdog: an EWMA of the step's wall time; a step over
    ``straggler_factor`` x the EWMA (after the first four steps of a run)
    is recorded and passed to the ``on_straggler`` hook;
  * the delta schedule is part of the run's identity: the checkpoint
    records the data version, and a resume whose schedule puts the last
    step at another version raises.

Determinism: the reference's contract is resume bit for bit
(``examples/train_lm_joinsampled.py``). ``train`` runs its loop under
``torch.use_deterministic_algorithms(True)`` (an operation without a
deterministic implementation raises; it never falls back quietly) and
restores the caller's setting after. On the card cuBLAS then needs
``CUBLAS_WORKSPACE_CONFIG`` set before its first call: ``main`` sets it
when absent.

``train_step`` keeps the reference's step exactly: AdamW with float32
moments under ``warmup_cosine(step, warmup=20, total=100000)``, whatever
``TrainConfig.warmup`` says (a defect of the reference, kept for parity).
``TrainConfig.lr`` is the peak rate.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import PoissonJoinSource, SyntheticLMSource, make_corpus_db
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.models import init_model, layers, loss_fn
from repro_torch.models.moe import Dispatch
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               warmup_cosine)

__all__ = ["TrainConfig", "train_step", "replicate", "split_batch",
           "entry_gradients", "reduce_gradients", "dp_train_step", "train",
           "main"]

# what cuBLAS needs for deterministic products (its documented setting)
CUBLAS_WORKSPACE = ":4096:8"


@dataclasses.dataclass
class TrainConfig:
    arch: str = "smollm_135m"
    reduced: bool = True
    steps: int = 200
    batch: int = 8
    seq_len: int = 64
    lr: float = 3e-3
    warmup: int = 20
    seed: int = 0
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    keep_n: int = 3
    straggler_factor: float = 3.0
    data: str = "poisson_join"  # or "synthetic"
    log_every: int = 10
    # Live-corpus schedule: ``(step, DeltaBatch)`` events applied by the
    # data source at step-aligned version barriers. The schedule is part of
    # the run's identity: resume replays it from the base snapshot, and the
    # checkpoint records the data version so a mismatched schedule fails
    # loudly instead of drifting silently.
    deltas: tuple = ()
    # The port's own: where the run lives (None: the card), and the mesh's
    # entries (None: every visible card, or one entry on ``device`` when
    # that is set; a list may repeat a device).
    device: Optional[str] = None
    devices: Optional[Sequence] = None


def train_step(model, opt_cfg: AdamWConfig, opt_state: Dict, batch: Dict,
               step: int):
    """One step, the reference's ``_train_step``: the loss's gradient
    (zeros for a parameter the loss does not reach, as ``jax.grad`` gives),
    then AdamW under ``warmup_cosine(step, warmup=20, total=100000)``. The
    model's parameters change in place. Returns ``(opt_state, metrics)``
    with ``metrics = {"grad_norm", "lr", "loss"}`` (0-d tensors)."""
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch)
    loss.backward()
    params = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in params.items()}
    lr_scale = warmup_cosine(step, warmup=20, total=100000)
    _, opt_state, metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                         lr_scale)
    metrics["loss"] = loss.detach()
    return opt_state, metrics


def replicate(model, device):
    """A copy of ``model`` on ``device``: the same bits."""
    return copy.deepcopy(model).to(device)


def split_batch(batch: Dict, devices: Sequence) -> List[Dict]:
    """The global batch's rows in ``len(devices)`` equal contiguous shares,
    in order, each on its device."""
    n = len(devices)
    shares = [{} for _ in devices]
    for key, value in batch.items():
        value = torch.as_tensor(value)
        for share, part, dev in zip(shares, value.chunk(n), devices):
            share[key] = part.to(dev)
    return shares


def _moe_layers(model) -> list:
    return [b.moe for b in model.blocks if b.btype == "moe"]


def _route_globally(replicas, shares, tokens: int) -> None:
    """Set every MoE layer's ``Dispatch`` on each replica for the global
    batch: each share routed in order without a gradient, each entry's
    layers told the assignments of the entries before it (its share of
    the capacity) and, once all are routed, the global batch's expert
    density."""
    moes = [_moe_layers(r) for r in replicas]
    running = [None] * len(moes[0])
    first = replicas[0].device
    with torch.no_grad():
        for r, share, layer in zip(replicas, shares, moes):
            own = share["tokens"].numel()
            for m, before in zip(layer, running):
                m.dispatch = Dispatch(tokens, own / tokens, None if before
                                      is None else before.to(r.device))
            loss_fn(r, share)
            running = [m.dispatch.counts.to(first) if before is None else
                       before + m.dispatch.counts.to(first)
                       for m, before in zip(layer, running)]
    for r, layer in zip(replicas, moes):
        for m, count in zip(layer, running):
            m.dispatch.density = (count.float() / tokens).to(r.device)


def entry_gradients(replicas, batch: Dict):
    """Each entry's share of ``batch``'s forward and backward on its
    replica, the shares' losses dividing by the global batch's count of
    counted tokens (their sum is the global batch's loss). Returns (the
    shares' losses, each entry's {name: gradient} on its device; zeros
    for a parameter the loss does not reach)."""
    devices = [r.device for r in replicas]
    shares = split_batch(batch, devices)
    mask = batch.get("mask")
    tokens = int(torch.as_tensor(batch["tokens"]).numel())
    total = tokens if mask is None else torch.as_tensor(mask).float().sum()
    moe = bool(_moe_layers(replicas[0]))
    losses, grads = [], []
    try:
        if moe:
            _route_globally(replicas, shares, tokens)
        for r, share in zip(replicas, shares):
            r.zero_grad(set_to_none=True)
            loss, _ = loss_fn(r, share, total=total if mask is None
                              else total.to(r.device))
            loss.backward()
            losses.append(loss.detach())
            grads.append({n: torch.zeros_like(p) if p.grad is None else
                          p.grad for n, p in r.named_parameters()})
    finally:
        for r in replicas:
            for m in _moe_layers(r):
                m.dispatch = None
    return losses, grads


def reduce_gradients(grads: Sequence[Dict[str, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
    """The entries' gradients summed into the first entry in their order:
    ``((g0 + g1) + g2) + ...``."""
    out = {}
    for name, g in grads[0].items():
        for other in grads[1:]:
            g = g + other[name].to(g.device)
        out[name] = g
    return out


def dp_train_step(replicas, opt_cfg: AdamWConfig, opt_state: Dict,
                  batch: Dict, step: int, grads_out: Optional[list] = None):
    """One data-parallel step over ``replicas`` (one model an entry, the
    first holding ``opt_state``): ``entry_gradients``, their sum in the
    first entry (``reduce_gradients``), the reference's AdamW update
    there, and the parameters copied to every other replica. Returns
    ``(opt_state, metrics)`` as ``train_step`` does. ``grads_out``, when
    given, receives each entry's gradients before the sum."""
    losses, grads = entry_gradients(replicas, batch)
    if grads_out is not None:
        grads_out.extend(grads)
    params = dict(replicas[0].named_parameters())
    lr_scale = warmup_cosine(step, warmup=20, total=100000)
    _, opt_state, metrics = adamw_update(opt_cfg, params,
                                         reduce_gradients(grads), opt_state,
                                         lr_scale)
    _broadcast(replicas)
    loss = losses[0]
    for other in losses[1:]:
        loss = loss + other.to(loss.device)
    metrics["loss"] = loss
    return opt_state, metrics


def _broadcast(replicas) -> None:
    """The first replica's parameters copied into every other one."""
    params = dict(replicas[0].named_parameters())
    with torch.no_grad():
        for r in replicas[1:]:
            for name, p in r.named_parameters():
                p.copy_(params[name])


def train(tc: TrainConfig, hooks: Optional[Dict[str, Callable]] = None
          ) -> Dict[str, Any]:
    hooks = hooks or {}
    cfg = configs.get_config(tc.arch)
    if tc.reduced:
        cfg = configs.reduced(cfg)
        cfg = dataclasses.replace(cfg, attn_chunk=max(tc.seq_len // 2, 16))

    # --- elastic mesh: dp degree derived from the mesh's entries ------------
    mesh = make_host_mesh(devices=tc.devices if tc.devices is not None
                          else tc.device)
    layers.set_batch_axes(
        batch_axes(mesh) if mesh.size > 1 and tc.batch % mesh.shape["data"]
        == 0 else ())
    axes = layers.get_batch_axes()
    entries = mesh.shard_devices(axes) if axes else [mesh.devices.flat[0]]
    device = entries[0]

    model = init_model(cfg, tc.seed, device=device)
    replicas = [model] + [replicate(model, d) for d in entries[1:]]
    params = dict(model.named_parameters())
    opt_cfg = AdamWConfig(lr=tc.lr, moment_dtype="float32")
    opt_state = adamw_init(opt_cfg, params)

    # --- data ---------------------------------------------------------------
    if tc.data == "poisson_join":
        db = make_corpus_db(n_docs=512, n_clusters=16, seq_len=tc.seq_len + 1,
                            vocab=cfg.vocab, seed=tc.seed, device=device)
        source = PoissonJoinSource(db, tc.seq_len + 1, tc.batch, seed=tc.seed,
                                   deltas=tc.deltas)
    else:
        source = SyntheticLMSource(cfg.vocab, tc.seq_len, tc.batch,
                                   seed=tc.seed, device=device)

    # --- resume ---------------------------------------------------------------
    ckpt = CheckpointManager(tc.ckpt_dir, keep_n=tc.keep_n)
    state_tpl = {"params": params, "opt": opt_state,
                 "data_version": np.zeros((), np.int64)}
    start, restored = ckpt.restore(state_tpl)
    if start is not None:
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(restored["params"][name])
        _broadcast(replicas)
        opt_state = restored["opt"]
        if hasattr(source, "version_at") and start > 0:
            want = source.version_at(start - 1)
            got = int(restored["data_version"])
            if got != want:
                raise RuntimeError(
                    f"checkpoint data_version={got} but the delta schedule "
                    f"puts step {start - 1} at version {want}; resume must "
                    f"replay the run's exact schedule")
        print(f"[train] resumed from step {start}")
    start = (start or 0)

    # --- loop with straggler watchdog ----------------------------------------
    ewma = None
    losses = []
    straggler_events = []
    doc_ids = []        # per-step sampled doc ids (poisson_join source)
    data_versions = []  # per-step snapshot version each batch was drawn at
    data_version = 0
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for step in range(start, tc.steps):
            batch = source.batch_at(step)
            batch.pop("sampled_k", None)
            step_docs = batch.pop("doc_ids", None)
            data_version = batch.pop("db_version", data_version)
            if step_docs is not None:
                doc_ids.append(step_docs.cpu().numpy())
            data_versions.append(data_version)
            t0 = time.time()
            if len(replicas) > 1:
                opt_state, metrics = dp_train_step(replicas, opt_cfg,
                                                   opt_state, batch, step)
            else:
                opt_state, metrics = train_step(model, opt_cfg, opt_state,
                                                batch, step)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if ewma is None:
                ewma = dt
            if dt > tc.straggler_factor * ewma and step > start + 3:
                straggler_events.append((step, dt, ewma))
                print(f"[train] STRAGGLER step {step}: {dt:.3f}s vs EWMA "
                      f"{ewma:.3f}s")
                if "on_straggler" in hooks:
                    hooks["on_straggler"](step, dt, ewma)
            ewma = 0.9 * ewma + 0.1 * dt
            losses.append(loss)
            if step % tc.log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if "on_step" in hooks:
                hooks["on_step"](step, loss)
            if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.steps:
                ckpt.save(step + 1, {"params": params, "opt": opt_state,
                                     "data_version": np.asarray(data_version,
                                                                np.int64)})
        ckpt.wait()
    finally:
        torch.use_deterministic_algorithms(was_deterministic,
                                           warn_only=warn_only)
    return {"losses": losses, "params": params, "replicas": replicas,
            "straggler_events": straggler_events, "doc_ids": doc_ids,
            "data_versions": data_versions, "final_step": tc.steps}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--data", default="poisson_join")
    ap.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card)")
    ap.add_argument("--devices", type=int, default=None,
                    help="entries of the data-parallel mesh (default: every "
                         "visible card, or one on --device): round-robin "
                         "over the visible cards, or all on --device")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices < 1:
        ap.error(f"--devices must be >= 1, got {args.devices}")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    out = train(TrainConfig(arch=args.arch, steps=args.steps,
                            batch=args.batch, seq_len=args.seq_len,
                            data=args.data, ckpt_dir=args.ckpt_dir,
                            reduced=not args.full, device=args.device,
                            devices=_entries(args.devices, args.device)))
    if out["losses"]:  # a run resumed at its last step trains none
        print(f"[train] done. loss {out['losses'][0]:.3f} -> "
              f"{out['losses'][-1]:.3f}")
    return out


def _entries(n: Optional[int], device: Optional[str]):
    """``--devices n`` as mesh entries: all on ``device`` when it names a
    device (not just "cuda"), else round-robin over the visible cards (a
    missing card raises in ``make_mesh``)."""
    if n is None:
        return None
    if device is not None and (torch.device(device).type != "cuda"
                               or torch.device(device).index is not None):
        return [device] * n
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i % max(count, 1)) for i in range(n)]


if __name__ == "__main__":
    main()
