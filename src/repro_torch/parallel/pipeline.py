"""Pipeline parallelism: the GPipe microbatch schedule
(``repro.parallel.pipeline``).

Layers are split into ``n_stages`` contiguous stages, one an entry of a
"stage" mesh axis. Microbatches march through the pipe, each stage handing
its activation to the next at every tick; a tick runs every stage on its
resident microbatch, so a forward pass takes ``n_micro + n_stages - 1``
ticks with GPipe's bubble fraction (S-1)/(M+S-1).

The reference runs the ticks as one SPMD program under ``shard_map``. The
port's single controller runs them from the host: at each tick, each
stage calls ``stage_fn`` on its entry's device with its slice of the
stacked parameters, and the hand-off is a copy to the next entry's device.
As in the reference, a warming or draining stage computes on zeros and
its result is dropped (the launches follow the schedule), and stage 0
records the last stage's output from tick ``n_stages - 1`` on.

Scope: the forward pipeline (inference and evaluation, or the building
block of a forward and backward interleaving).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.models.transformer import _apply_block

__all__ = ["pipeline_forward", "reference_forward", "transformer_stages"]

Params = Dict[str, Any]


def _slice(stage_params: Params, s: int, device=None) -> Params:
    """Stage ``s``'s slice of a stacked parameter dict (nested dicts of
    tensors with a leading stage axis), on ``device``."""
    out = {}
    for k, v in stage_params.items():
        if isinstance(v, dict):
            out[k] = _slice(v, s, device)
        else:
            out[k] = v[s] if device is None else v[s].to(device)
    return out


def _n_stages(stage_params: Params) -> int:
    for v in stage_params.values():
        return _n_stages(v) if isinstance(v, dict) else int(v.shape[0])
    raise ValueError("stage_params holds no tensor")


def pipeline_forward(stage_fn: Callable, stage_params: Params,
                     batch: torch.Tensor, mesh, axis: str = "stage"
                     ) -> torch.Tensor:
    """Run the GPipe forward schedule: ``stage_fn(params, x) -> y``
    (shape-preserving) on every stage, ``stage_params`` stacked on a
    leading stage axis of ``mesh.shape[axis]``, ``batch`` (n_micro, micro,
    ...). Returns (n_micro, micro, ...) outputs on stage 0's device."""
    n_stages = mesh.shape[axis]
    if _n_stages(stage_params) != n_stages:
        raise ValueError(f"stage_params stack {_n_stages(stage_params)} "
                         f"stages for an axis of {n_stages}")
    n_micro = batch.shape[0]
    ticks = n_micro + n_stages - 1
    devices = mesh.shard_devices((axis,))
    params = [_slice(stage_params, s, devices[s]) for s in range(n_stages)]
    fresh = batch.to(devices[0])
    zeros = torch.zeros_like(fresh[0])
    outs = torch.zeros_like(fresh)
    buf: List[torch.Tensor] = [torch.zeros_like(fresh[0]).to(d)
                               for d in devices]   # resident inputs
    for t in range(ticks):
        ys = []
        for s in range(n_stages):
            if s == 0:
                x = fresh[t] if t < n_micro else zeros
            else:
                x = buf[s]
            ys.append(stage_fn(params[s], x))
        # hand each activation to the next stage; the last stage's output
        # rings back to stage 0, which records it
        buf = [ys[(s - 1) % n_stages].to(devices[s])
               for s in range(n_stages)]
        done = t - (n_stages - 1)
        if done >= 0:
            outs[done] = buf[0]
    return outs


def reference_forward(stage_fn: Callable, stage_params: Params,
                      batch: torch.Tensor) -> torch.Tensor:
    """Oracle: every stage in turn on each microbatch (no pipeline)."""
    n_stages = _n_stages(stage_params)
    out = []
    for x in batch:
        for s in range(n_stages):
            x = stage_fn(_slice(stage_params, s), x)
        out.append(x)
    return torch.stack(out)


class _Layer(nn.Module):
    """One layer of ``model`` as a module call, for ``functional_call``:
    ``block`` is the template whose parameters a stage's slice replaces."""

    def __init__(self, model, block):
        super().__init__()
        object.__setattr__(self, "model", model)  # not a submodule
        self.block = block

    def forward(self, h, positions):
        return _apply_block(self.model, self.block, h, positions, None, {})


def transformer_stages(model, n_stages: int) -> Tuple[Callable, Params]:
    """``model``'s decoder layers as ``n_stages`` contiguous stages of equal
    depth, for ``pipeline_forward``: (stage_fn, stage_params). Each
    parameter of a layer is stacked to (n_stages, layers a stage, ...);
    ``stage_fn(params, h)`` runs a stage's layers in order over hidden
    states (micro, S, d_model) with positions 0..S-1 (the embedding, the
    final norm and the MoE aux loss stay outside). The layers must share
    one set of parameter names and shapes (one block type)."""
    blocks = list(model.blocks)
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} layers do not split into "
                         f"{n_stages} stages")
    per = len(blocks) // n_stages
    shapes = {n: p.shape for n, p in blocks[0].named_parameters()}
    for b in blocks:
        if b.btype != blocks[0].btype or {
                n: p.shape for n, p in b.named_parameters()} != shapes:
            raise ValueError("transformer_stages needs one block type")
    with torch.no_grad():
        stage_params = {n: torch.stack([torch.stack([
            dict(blocks[s * per + j].named_parameters())[n]
            for j in range(per)]) for s in range(n_stages)])
            for n in shapes}
    layer = _Layer(model, blocks[0])

    def stage_fn(params: Params, h: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(h.shape[1], device=h.device)
        for j in range(per):
            h = functional_call(layer, {f"block.{n}": v[j]
                                        for n, v in params.items()},
                                (h, positions))
        return h

    return stage_fn, stage_params
