"""Layout plumbing and policy dispatch around the kernels: the port's
public kernel API, with the reference's signatures (``kernels/ops.py``).

Each wrapper takes ``policy=``: a disabled policy routes it through its
library or plain version (``torch.searchsorted``, ``torch.cumsum``, the
``ref`` oracles). With an enabled policy a CUDA tensor launches the
kernel or raises, and a CPU tensor runs the kernel's plain version.

The port's kernels mask their own ragged edges, so nothing is padded:
``prefix_sum`` and ``geo_positions_fused`` pass flat vectors, and the
attention kernels leave keys past S out. That keeps the reference's
answers wherever its padding is right, and is right where the
reference's is not: its ``prefill_attention`` pads K and V with zeros to
the block lcm and, non-causal, lets the padded keys into the softmax.

Attention routes by dtype, one kernel each and no fallback between them:
bf16 runs the tensor-core kernels (``wgmma`` prefill, ``mma.sync``
decode), float32 the CUDA-core ones, as the reference computes in float32
and TF32 would not keep its tolerances.

Tiles resolve as in the reference, through ``autotune.tile_for``: the
policy's ``tile_overrides``, then the committed ``TUNE_TABLE.json`` under
the card's key (then its ``default`` entry), by the problem's size bucket,
then the kernel's builtin. ``searchsorted_prefix`` resolves
``bsearch_probe``'s ``block_rows`` by the number of queries;
``decode_attention`` ``flash_decode``'s ``block_s`` by S; and
``prefill_attention`` ``flash_prefill``'s ``(block_q, block_k)`` by S. An
explicit ``block_s``, ``block_q`` or ``block_k`` pins its axis over the
ladder; each kernel then launches its largest instance at or below the
tile for the dtype and head dim (``flash_decode.decode_config``,
``flash_prefill.prefill_config``), and a value that names no instance
raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import DEFAULT_POLICY, KernelPolicy

from . import ref
from .autotune import tile_for
from .bsearch_probe import bsearch_probe
from .flash_decode import flash_decode
from .flash_prefill import FlashPrefill
from .geo_gaps import geo_gaps_tiles
from .prefix_sum import prefix_sum_tiles

__all__ = ["to_tiles", "searchsorted_prefix", "prefix_sum",
           "geo_positions_fused", "decode_attention", "prefill_attention",
           "ref"]


def to_tiles(x: torch.Tensor, fill=0) -> torch.Tensor:
    """Pad a 1-D vector to a whole number of 128-lane rows and retile —
    the reference kernels' (R, 128) query layout."""
    n = x.shape[0]
    rows = -(-n // 128)
    return F.pad(x, (0, rows * 128 - n), value=fill).reshape(rows, 128)


def searchsorted_prefix(pref: torch.Tensor, q: torch.Tensor,
                        policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """max j with pref[j] <= q (== ``searchsorted(pref, q, right) - 1``
    clamped at 0). The bsearch kernel for int32 tables and queries; the
    library search for every other dtype (int64 joins, float masses)."""
    if (pref.dtype != torch.int32 or q.dtype != torch.int32
            or not policy.enabled):
        return torch.clamp(torch.searchsorted(pref, q, right=True) - 1, min=0)
    return bsearch_probe(pref, q, block_rows=tile_for(
        "bsearch_probe", q.numel(), policy, q.device))


def prefix_sum(x: torch.Tensor, exclusive: bool = False, *,
               policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Prefix sum of a 1-D vector (the index's pref column). int32 and
    float32 take the scan kernel; int64 (joins past 2^31) takes
    ``torch.cumsum``, as the reference routes it."""
    if x.dtype == torch.int64 or not policy.enabled:
        s = torch.cumsum(x, 0, dtype=x.dtype)
    else:
        s = prefix_sum_tiles(x)
    if exclusive:
        s = torch.cat([s.new_zeros(1), s[:-1]])
    return s


def geo_positions_fused(u: torch.Tensor, p, *,
                        policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Fused uniform -> geometric -> positions transform (ascending int32)."""
    u = u.to(torch.float32)
    if not policy.enabled:
        return ref.geo_gaps_ref(u, p)
    return geo_gaps_tiles(u, p)


def decode_attention(q, k, v, bias=None, *, block_s: Optional[int] = None,
                     policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Online-softmax decode attention: q (B, H, D), k/v (B, KV_H, S, D),
    bias (B, S) additive float32 (zeros when None). bf16 takes the
    tensor-core kernel, float32 the CUDA-core one. ``block_s`` (keys a
    ring stage) pins the tile; ``None`` resolves it through the ladder
    (``tile_for('flash_decode', S)``). The splits stay the kernel
    wrapper's choice."""
    S = k.shape[2]
    if block_s is None:
        block_s = tile_for("flash_decode", S, policy, q.device)
    if bias is None:
        bias = torch.zeros((q.shape[0], S), dtype=torch.float32,
                           device=q.device)
    if not policy.enabled:
        return ref.flash_decode_ref(q, k, v, bias)
    return flash_decode(q, k, v, bias, block_s)


def prefill_attention(q, k, v, *, causal: bool = True,
                      block_q: Optional[int] = None,
                      block_k: Optional[int] = None,
                      policy: KernelPolicy = DEFAULT_POLICY) -> torch.Tensor:
    """Causal (or full) flash attention over full sequences: q (B, H, S,
    D), k/v (B, KV, S, D). bf16 takes the tensor-core kernel, float32 the
    CUDA-core one, through ``flash_prefill.FlashPrefill``: the kernel's
    launch, with a gradient when autograd records one. ``(block_q,
    block_k)`` (query rows a block, keys a tile) resolves through the
    ladder (``tile_for('flash_prefill', S)``); an explicit value pins its
    axis."""
    tq, tk = tile_for("flash_prefill", q.shape[2], policy, q.device)
    block_q = tq if block_q is None else block_q
    block_k = tk if block_k is None else block_k
    if not policy.enabled:
        return ref.flash_prefill_ref(q, k, v, causal=causal)
    return FlashPrefill.apply(q, k, v, causal, block_q, block_k)
