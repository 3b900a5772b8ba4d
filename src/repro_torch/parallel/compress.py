"""Int8 gradient compression with error feedback for the data-parallel
all-reduce (``repro.parallel.compress``).

At 1000+ nodes the inter-pod gradient all-reduce is the scaling wall;
8-bit quantization cuts that traffic 4x against float32 (2x against
bf16). Scaling is symmetric and per tensor; the quantization residual is
carried in an error-feedback buffer so that the *accumulated* update
stays unbiased (Seide et al. / EF-SGD).

The reference runs inside ``shard_map``, one program a shard. The port has
one controller: ``compressed_psum_grads`` takes every entry's gradients
and errors at once, each entry's tensors on its entry's device, and its
collectives (the scale's max, the int32 sum) are copies from entry to
entry in the mesh's shard order: the same code over entries on one card
or on several.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["compress_int8", "decompress_int8", "compressed_psum_grads"]

F32 = torch.float32


def _scale(g32: torch.Tensor) -> torch.Tensor:
    """``max(max|g|, 1e-12) / 127`` in float32, a 0-d tensor."""
    return torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0


def _quantize(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(g / scale), -127, 127)`` as int8 (round half to even,
    as ``jnp.round``)."""
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    g32 = g.to(F32)
    scale = _scale(g32)
    return _quantize(g32, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def _ring(values: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    """``op`` folded over ``values`` in order, each partial copied to the
    next value's device, then the result copied back to every device: the
    port's collective over a mesh axis."""
    acc = values[0]
    for v in values[1:]:
        acc = op(acc.to(v.device), v)
    return [acc.to(v.device) for v in values]


def compressed_psum_grads(grads: Sequence[Dict[str, torch.Tensor]],
                          err: Sequence[Dict[str, torch.Tensor]],
                          mesh, axis) -> Tuple[List[Dict[str, torch.Tensor]],
                                               List[Dict[str, torch.Tensor]]]:
    """The error-feedback compressed mean of the gradients over ``axis``
    (a mesh axis name or a tuple of them). ``grads`` and ``err`` hold one
    dict an entry of ``axis``, in ``mesh.shard_coords(axis)`` order, with
    the same keys. For each key: every entry's corrected gradient ``g +
    e`` (float32) is scaled by the largest per-entry scale (``pmax``),
    rounded to int8 codes, the codes are summed in int32 (``psum``) and the
    mean ``sum * scale / n`` is cast to the gradient's dtype. Returns
    (each entry's mean, each entry's new error ``corrected - q *
    scale``), each tensor on its entry's device."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = len(mesh.shard_coords(axes))
    if len(grads) != n or len(err) != n:
        raise ValueError(f"{len(grads)} gradient and {len(err)} error dicts "
                         f"for {n} entries of {axes}")
    means: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    errors: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for key in grads[0]:
        corrected = [g[key].to(F32) + e[key] for g, e in zip(grads, err)]
        scales = _ring([_scale(c) for c in corrected], torch.maximum)
        q = [_quantize(c, s) for c, s in zip(corrected, scales)]
        sums = _ring([c.to(torch.int32) for c in q], torch.add)
        for i in range(n):
            errors[i][key] = corrected[i] - q[i].to(F32) * scales[i]
            means[i][key] = (sums[i].to(F32) * scales[i] / n).to(
                grads[i][key].dtype)
    return means, errors
