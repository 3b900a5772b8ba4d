"""Core neural building blocks: parameter initialization, the norm and MLP
modules, and the pure functions over them (``repro.models.layers``).

Parameters keep the reference's leaf names and its ``(in, out)`` layout,
used as ``x @ W``. Computation casts each weight to the config's compute
dtype at its use, as the reference casts at every einsum; ``cast`` keeps
the cast copy of a parameter while the parameter is unchanged and no
gradient flows, so serving in bf16 casts each weight once.

The reference's sharding rules (``param_specs``, ``shardings_for``,
``sanitize_pspecs``, ``set_batch_axes``, ``shard_batch*``) are absent:
they wait for ``parallel/*`` (ROADMAP A.5.4), and the port's forward passes
run on one card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

__all__ = ["dtype_of", "cast", "Initializer", "Norm", "MLP", "rms_norm",
           "rope", "gated_mlp", "init_mlp", "init_norm", "cross_entropy_loss"]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def cast(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``w`` in ``dt``. A parameter's cast copy is made once and reused
    while the parameter keeps its storage and version and no gradient
    flows through it; under autograd every call casts anew."""
    if w.dtype == dt:
        return w
    if not isinstance(w, nn.Parameter) or (w.requires_grad
                                           and torch.is_grad_enabled()):
        return w.to(dt)
    key = (dt, w.data_ptr(), w._version)
    kept = getattr(w, "_cast_copy", None)
    if kept is None or kept[0] != key:
        with torch.no_grad():
            kept = (key, w.detach().to(dt))
        w._cast_copy = kept
    return kept[1]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

class Initializer:
    """Parameter init from an explicit ``torch.Generator``, with the
    reference's scales: normal scaled by ``1/sqrt(fan_in)`` (``shape[-2]``,
    or ``shape[-1]`` for a vector) unless a scale is given, zeros, ones.
    Values are drawn in float32 on the CPU in the order the model asks for
    them, then cast to the parameter dtype. The reference folds a key from
    each leaf's path instead (through ``hash``, which changes from process
    to process), so neither init reproduces the other: parity tests carry
    the reference's parameters across (``convert.params_from_reference``).
    With ``generator=None`` every tensor is left uninitialized, to be
    loaded."""

    def __init__(self, generator: Optional[torch.Generator],
                 param_dtype: torch.dtype = torch.float32):
        self.generator = generator
        self.dtype = param_dtype

    def normal(self, shape, scale: float = None) -> nn.Parameter:
        if self.generator is None:
            return nn.Parameter(torch.empty(shape, dtype=self.dtype))
        if scale is None:
            scale = 1.0 / np.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
        w = torch.randn(shape, generator=self.generator, dtype=torch.float32)
        return nn.Parameter((w * scale).to(self.dtype))

    def zeros(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, dtype=self.dtype))

    def ones(self, shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, dtype=self.dtype))


class Norm(nn.Module):
    """An RMS norm's ``scale`` (applied as ``1 + scale``)."""

    def __init__(self, ini: Initializer, d: int):
        super().__init__()
        self.scale = ini.zeros((d,))


class MLP(nn.Module):
    """``w_up``, ``w_down`` and, when gated (SwiGLU), ``w_gate``."""

    def __init__(self, ini: Initializer, d: int, ff: int, gated: bool = True):
        super().__init__()
        self.w_up = ini.normal((d, ff))
        self.w_down = ini.normal((ff, d))
        if gated:
            self.w_gate = ini.normal((d, ff))


def init_mlp(ini: Initializer, d: int, ff: int, gated: bool = True) -> MLP:
    return MLP(ini, d, ff, gated)


def init_norm(ini: Initializer, d: int) -> Norm:
    return Norm(ini, d)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """In float32, scaled by ``1 + scale``, back in x's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Rotates halves (not
    interleaved pairs), angles in float32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq           # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def gated_mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU when ``p`` has ``w_gate`` (the llama family), else the plain
    tanh-GELU MLP (starcoder2, whisper: ``jax.nn.gelu``'s default form)."""
    dt = dtype_of(cfg.compute_dtype)
    u = x @ cast(p.w_up, dt)
    if hasattr(p, "w_gate"):
        u = F.silu(x @ cast(p.w_gate, dt)) * u
    else:
        u = F.gelu(u, approximate="tanh")
    return u @ cast(p.w_down, dt)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       z_loss: float = 1e-4) -> torch.Tensor:
    """Causal-LM loss in float32, with the optional z-loss."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse ** 2
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
