"""Fused GEO positions: uniforms -> geometric gaps -> ascending positions.

    step = min(floor(log(max(u, 1e-12)) / log1p(-clip(p))), 2e9) + 1
    pos  = running sum of step - 1                         (int32)

``geo_gaps_tiles`` launches ``csrc/scan.cu``'s ``geo_gaps_launch`` for
CUDA tensors (the prefix-sum kernel with the step as its prologue and
``- 1`` as its epilogue) and runs ``geo_gaps_plain`` for CPU tensors;
``launches`` counts its calls that launch the kernel.

The step keeps the reference's divide (not a reciprocal multiply):
``floor`` turns a last-ulp difference into an off-by-one position. ``p``
is clipped in float32 as the reference clips it, and ``log1p(-p)`` is
taken on the device in both versions. Positions wrap as int32 sums wrap.

``out_of_bounds`` launches the checked build of ``geo_gaps_launch``
(``prefix_sum.checked_launch``): a measurement, counted in no
``launches``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .prefix_sum import checked_launch, scan_launch, wrap_i32

__all__ = ["clip_p", "geo_steps_plain", "geo_gaps_plain", "geo_gaps_tiles",
           "out_of_bounds"]

_STEP_MAX = 2_000_000_000.0  # the gap's clamp before the int32 cast


@functools.lru_cache(maxsize=256)
def _clip_f32(p: float) -> float:
    return float(np.clip(np.float32(p), np.float32(1e-12),
                         np.float32(1.0 - 1e-7)))


def clip_p(p) -> float:
    """``p`` clipped to [1e-12, 1 - 1e-7] in float32, as the reference
    (numpy's float32 clip, once per value of ``p``)."""
    return _clip_f32(float(p))


def geo_steps_plain(u: torch.Tensor, p) -> torch.Tensor:
    """int32 steps (gap + 1) of float32 uniforms ``u``."""
    pc = torch.tensor(clip_p(p), dtype=torch.float32, device=u.device)
    gaps = torch.floor(torch.log(torch.clamp(u, min=1e-12)) / torch.log1p(-pc))
    return torch.clamp(gaps, max=_STEP_MAX).to(torch.int32) + 1


def geo_gaps_plain(u: torch.Tensor, p) -> torch.Tensor:
    """int32 positions of ``u``'s shape (flat row-major running sums)."""
    steps = geo_steps_plain(u.to(torch.float32), p).reshape(-1)
    pos = wrap_i32(torch.cumsum(steps.to(torch.int64), 0) - 1)
    return pos.reshape(u.shape)


def geo_gaps_tiles(u: torch.Tensor, p) -> torch.Tensor:
    """u: float32 uniforms in (0, 1), any shape (the reference takes
    ``(R, 128)`` tiles); p: a probability. Returns int32 positions of
    u's shape, ascending in flat order."""
    if u.dtype != torch.float32:
        raise TypeError(f"geo_gaps_tiles takes float32 uniforms, got {u.dtype}")
    if u.device.type == "cpu":
        return geo_gaps_plain(u, p)
    if u.device.type != "cuda":
        raise ValueError(f"geo_gaps_tiles: unsupported device {u.device}")
    uc = u.contiguous()
    out = torch.empty_like(uc, dtype=torch.int32)
    if uc.numel() == 0:
        return out
    scan_launch("geo_gaps", uc, out, clip_p(p))
    geo_gaps_tiles.launches += 1
    return out


geo_gaps_tiles.launches = 0


def out_of_bounds(u: torch.Tensor, p, out=None) -> dict:
    """The checked build of ``geo_gaps_tiles``'s launch over ``u`` (as
    given) into ``out`` (``None``: a new int32 tensor):
    ``prefix_sum.checked_launch``'s result."""
    if u.dtype != torch.float32:
        raise TypeError(f"out_of_bounds takes float32 uniforms, got {u.dtype}")
    uc = u.contiguous()
    if out is None:
        out = torch.empty_like(uc, dtype=torch.int32)
    return checked_launch("geo_gaps", uc, out, clip_p(p))
