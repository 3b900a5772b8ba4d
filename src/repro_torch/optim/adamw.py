"""AdamW (+ optional factored second moment) over a model's named
parameters, ``repro.optim.adamw``.

The reference maps a pure function over its parameter pytree; here
``params`` and ``grads`` are mappings from a parameter's name (as
``Module.named_parameters`` gives it) to its tensor, and ``adamw_update``
writes the new values into the parameters and the moments in place under
``torch.no_grad()``. The arithmetic is the reference's, operation for
operation in float32: Python constants enter as float32 operands, the
bias corrections are float32 powers of a float32 step, the update reads
the float32 moments before they are cast to ``moment_dtype``, and weight
decay applies to every parameter, norms and embeddings included.
``torch.optim.AdamW`` is not used: its foreach and fused paths round
differently, it orders the decay and the update differently, and it has no
factored moment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "clip_by_global_norm", "adamw_update",
           "UPDATE_RANGE"]

F32 = torch.float32
# the ``torch.profiler`` range of ``adamw_update`` (a training step's device
# time by kind reads it)
UPDATE_RANGE = "adamw_update"


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"        # "bfloat16" halves optimizer memory
    factored: bool = False               # Adafactor-style v for matrices


def _mdt(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else F32


def _mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The float32 sum times the count's float32 reciprocal: ``jnp.mean``
    as XLA compiles it (its division by a constant becomes that product);
    ``torch.mean`` scales in double on the CPU."""
    return torch.sum(x, dim=dim) * (1.0 / x.shape[dim])


def adamw_init(cfg: AdamWConfig, params: Mapping[str, torch.Tensor]) -> Dict:
    """``{"step": 0-d int32, "m": {name: zeros}, "v": {name: zeros, or
    {"vr", "vc"} for a factored matrix}}`` on each parameter's device."""
    mdt = _mdt(cfg)

    def init_v(p):
        if cfg.factored and p.ndim >= 2:
            return {"vr": p.new_zeros(p.shape[:-1], dtype=mdt),
                    "vc": p.new_zeros(p.shape[:-2] + p.shape[-1:], dtype=mdt)}
        return torch.zeros_like(p, dtype=mdt)

    first = next(iter(params.values()))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "m": {n: torch.zeros_like(p, dtype=mdt) for n, p in params.items()},
        "v": {n: init_v(p) for n, p in params.items()},
    }


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The float32 sum of squares over every gradient (added leaf by leaf
    in order), its square root, and each gradient scaled by ``min(1,
    max_norm / max(norm, 1e-9))`` in float32, back in its dtype."""
    g2 = None
    for g in grads.values():
        s = torch.sum(torch.square(g.to(F32)))
        g2 = s if g2 is None else g2 + s
    norm = torch.sqrt(g2)
    # a true division: torch's ``number / tensor`` multiplies by a reciprocal
    top = torch.as_tensor(max_norm, dtype=F32, device=norm.device)
    scale = torch.clamp(top / torch.clamp(norm, min=1e-9), max=1.0)
    return ({n: (g.to(F32) * scale).to(g.dtype) for n, g in grads.items()},
            norm)


def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict,
                 lr_scale=1.0) -> Tuple[Mapping, Dict, Dict]:
    """One AdamW step, in place: the parameters and the moments of
    ``state`` take their new values. Returns ``(params, state, metrics)``
    with ``metrics = {"grad_norm", "lr"}`` (0-d float32 tensors)."""
    with torch.no_grad(), torch.profiler.record_function(UPDATE_RANGE):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        step = state["step"] + 1
        t = step.to(F32)
        bc1 = 1.0 - torch.pow(cfg.b1, t)
        bc2 = 1.0 - torch.pow(cfg.b2, t)
        lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32)
        for name, p in params.items():
            g32 = grads[name].to(F32)
            m, v = state["m"][name], state["v"][name]
            m32 = m.to(F32) * cfg.b1 + g32 * (1 - cfg.b1)
            if isinstance(v, dict):  # factored second moment
                g2 = g32 * g32
                vr = v["vr"].to(F32) * cfg.b2 + _mean(g2, -1) * (1 - cfg.b2)
                vc = v["vc"].to(F32) * cfg.b2 + _mean(g2, -2) * (1 - cfg.b2)
                vhat = (vr[..., None] * vc[..., None, :]) / torch.clamp(
                    _mean(vr, -1)[..., None, None], min=1e-30)
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                vhat = v.to(F32) * cfg.b2 + g32 * g32 * (1 - cfg.b2)
                v.copy_(vhat)
            upd = (m32 / bc1) / (torch.sqrt(vhat / bc2) + cfg.eps)
            p32 = p.to(F32)
            p.copy_(p32 - lr * (upd + cfg.weight_decay * p32))
            m.copy_(m32)
        state["step"] = step
    metrics = {"grad_norm": gnorm, "lr": lr.detach().clone()}
    return params, state, metrics
