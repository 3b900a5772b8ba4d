"""Attention blocks: GQA self-attention (full / windowed causal /
bidirectional), cross-attention, and single-token decode
(``repro.models.attention``).

Each case takes one route, decided by the case:

  * full-sequence self-attention over positions 0..S-1 with no window,
    causal or bidirectional: ``ops.prefill_attention`` (the ``flash_prefill``
    kernels on the card);
  * windowed self-attention (gemma3's local layers) and cross-attention
    over M memory tokens (S != M): ``blockwise_attention``, the port's twin
    of the reference's pure-JAX function (no kernel of the repo takes a
    window or S != T);
  * one-token decode, self (window included) and over memory:
    ``ops.decode_attention`` (the ``flash_decode`` kernels) over the whole
    cache with an additive bias: 0 on keys ``t <= cur`` (and ``t > cur -
    window``), -1e30 elsewhere, as the reference masks its whole cache.

The ops wrappers launch a kernel for CUDA tensors and run its plain
version for CPU tensors; a disabled ``KernelPolicy`` runs the plain
versions anywhere (``chip_smoke.py`` compares the two on the card).

The decode cache is kept in the kernels' ``(B, KV, T, hd)`` layout and each
step writes its K and V in place.

With ``attn_head_shard`` the reference's ``blockwise_attention`` reads
query heads g-major (head h in KV group ``h % KV``) and writes the output
back in that order, while its ``decode_self_attention`` groups them
``h // G``, so its forward pass and its prefill (decode steps) differ. The
port follows both: the forward pass reorders the heads to the kernels'
``h // G`` grouping before the call and back after it; prefill and decode
group them ``h // G`` (``self_attention(head_shard=False)``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import DEFAULT_POLICY, KernelPolicy
from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import (Initializer, cast, dtype_of, merge_last, rope,
                     shard_batch, shard_batch_seq, unflatten)

NEG_INF = -1e30

__all__ = ["NEG_INF", "Attention", "init_attention", "blockwise_attention",
           "self_attention", "cross_attention", "memory_kv", "decode_bias",
           "decode_self_attention", "decode_cross_attention"]


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo``; a cross block also ``c_wq``,
    ``c_wk``, ``c_wv``, ``c_wo``."""

    def __init__(self, ini: Initializer, cfg: ModelConfig, cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        H, KV = cfg.n_heads, cfg.n_kv_heads
        self.wq = ini.normal((d, H * hd))
        self.wk = ini.normal((d, KV * hd))
        self.wv = ini.normal((d, KV * hd))
        self.wo = ini.normal((H * hd, d))
        if cross:
            self.c_wq = ini.normal((d, H * hd))
            self.c_wk = ini.normal((d, KV * hd))
            self.c_wv = ini.normal((d, KV * hd))
            self.c_wo = ini.normal((H * hd, d))


def init_attention(ini: Initializer, cfg: ModelConfig,
                   cross: bool = False) -> Attention:
    return Attention(ini, cfg, cross)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    dt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = unflatten(x @ cast(p.wq, dt), -1, (H, hd))
    k = unflatten(x @ cast(p.wk, dt), -1, (KV, hd))
    v = unflatten(x @ cast(p.wv, dt), -1, (KV, hd))
    return q, k, v


def _group_major_to_kernel(x: torch.Tensor, KV: int) -> torch.Tensor:
    """(..., H, hd) with head ``g * KV + j`` -> head ``j * G + g``."""
    *lead, H, hd = x.shape
    return x.reshape(*lead, H // KV, KV, hd).transpose(-3, -2).reshape(
        *lead, H, hd)


def _kernel_to_group_major(x: torch.Tensor, KV: int) -> torch.Tensor:
    """The inverse of ``_group_major_to_kernel``."""
    *lead, H, hd = x.shape
    return x.reshape(*lead, KV, H // KV, hd).transpose(-3, -2).reshape(
        *lead, H, hd)


def blockwise_attention(
    q: torch.Tensor,            # (B, S, H, hd)
    k: torch.Tensor,            # (B, T, KV, hd)
    v: torch.Tensor,            # (B, T, KV, hd)
    q_pos: torch.Tensor,        # (S,) absolute positions of queries
    kv_pos: torch.Tensor,       # (T,)
    *,
    causal: bool,
    window: int = 0,
    chunk: int = 1024,
    head_shard: bool = False,
    probs_bf16: bool = False,
) -> torch.Tensor:
    """Online softmax over KV chunks of ``chunk`` keys, as the reference's
    scan computes it (its ``seq_shard`` only places the operands on a mesh
    and is not taken)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    acc_dt = torch.bfloat16 if probs_bf16 else torch.float32
    if head_shard:  # g-major heads: (B, S, G, KV, hd) -> (B, S, KV, G, hd)
        qg = q.reshape(B, S, G, KV, hd).transpose(2, 3).to(acc_dt) * scale
        k, v = shard_batch(k), shard_batch(v)
    else:
        qg = q.reshape(B, S, KV, G, hd).to(acc_dt) * scale

    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-10**9)
    nC = (T + pad) // chunk
    m = torch.full((B, S, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, KV, G, hd), dtype=torch.float32, device=q.device)
    for c in range(nC):
        kc = k[:, c * chunk:(c + 1) * chunk].to(acc_dt)
        vc = v[:, c * chunk:(c + 1) * chunk].to(acc_dt)
        pc = kv_pos[c * chunk:(c + 1) * chunk]
        s = torch.einsum("bskgh,bckh->bskgc", qg, kc).float()
        if causal:
            valid = pc[None, :] <= q_pos[:, None]
        else:
            valid = (pc[None, :] >= 0).expand(S, -1)
        valid = valid & (pc[None, :] >= 0)
        if window > 0:
            valid = valid & (pc[None, :] > q_pos[:, None] - window)
        s = torch.where(valid[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        prob = torch.exp(s - m_new[..., None])
        l = l * alpha + prob.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bskgc,bckh->bskgh", prob.to(acc_dt), vc).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    if head_shard:  # back to the g-major flattened layout wo expects
        out = out.transpose(2, 3)
    return out.reshape(B, S, H, hd).to(q.dtype)


def _prefill_route(q, k, v, KV: int, causal: bool, head_shard: bool,
                   policy: KernelPolicy) -> torch.Tensor:
    """Self-attention over positions 0..S-1 through ``ops.prefill_attention``:
    (B, S, H, hd) in and out, heads g-major when ``head_shard``."""
    if head_shard:
        q = _group_major_to_kernel(q, KV)
    out = ops.prefill_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                policy=policy).transpose(1, 2)
    if head_shard:
        out = _kernel_to_group_major(out, KV)
    return out


def self_attention(
    p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
    *, causal: bool = True, window: int = 0,
    head_shard: Optional[bool] = None,
    policy: KernelPolicy = DEFAULT_POLICY,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self attention over positions 0..S-1 (train /
    prefill). Returns the output and the roped (k, v), (B, S, KV, hd).
    ``head_shard`` (default ``cfg.attn_head_shard``) reads the query heads
    g-major, as the reference's forward pass does."""
    B, S, _ = x.shape
    if head_shard is None:
        head_shard = cfg.attn_head_shard
    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, positions[None, :], cfg.rope_theta)
    k = rope(k, positions[None, :], cfg.rope_theta)
    if cfg.attn_seq_shard:  # the reference's sequence-parallel layout
        q, k, v = shard_batch_seq(q, 1), shard_batch(k), shard_batch(v)
    if window > 0:
        out = blockwise_attention(q, k, v, positions, positions,
                                  causal=causal, window=window,
                                  chunk=cfg.attn_chunk, head_shard=head_shard,
                                  probs_bf16=cfg.attn_probs_bf16)
    else:
        out = _prefill_route(q, k, v, cfg.n_kv_heads, causal, head_shard,
                             policy)
    dt = dtype_of(cfg.compute_dtype)
    out = merge_last(out)
    if cfg.attn_seq_shard:
        out = shard_batch(out)  # S gathered back before the row-parallel wo
    return out @ cast(p.wo, dt), (k, v)


def cross_attention(p: Attention, x: torch.Tensor, memory_kv, cfg: ModelConfig
                    ) -> torch.Tensor:
    """x attends to a precomputed (k, v) of the encoder memory."""
    dt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    mk, mv = memory_kv  # (B, M, KV, hd)
    M = mk.shape[1]
    q = unflatten(x @ cast(p.c_wq, dt), -1, (H, hd))
    out = blockwise_attention(q, mk, mv, torch.arange(S, device=x.device),
                              torch.arange(M, device=x.device), causal=False,
                              chunk=cfg.attn_chunk)
    return merge_last(out) @ cast(p.c_wo, dt)


def memory_kv(p: Attention, memory: torch.Tensor, cfg: ModelConfig):
    """Project encoder memory once (prefill) for later cross attention:
    (B, M, KV, hd) each."""
    dt = dtype_of(cfg.compute_dtype)
    B, M, _ = memory.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    mk = unflatten(memory @ cast(p.c_wk, dt), -1, (KV, hd))
    mv = unflatten(memory @ cast(p.c_wv, dt), -1, (KV, hd))
    return mk, mv


def decode_bias(B: int, T: int, cur: int, window: int = 0,
                device=None) -> torch.Tensor:
    """(B, T) float32: 0 on keys ``t <= cur`` (and ``t > cur - window``
    when windowed), -1e30 elsewhere."""
    t = torch.arange(T, device=device)
    valid = t <= cur
    if window > 0:
        valid = valid & (t > cur - window)
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32).expand(
        B, T).contiguous()


def decode_self_attention(
    p: Attention, x: torch.Tensor, cfg: ModelConfig,
    cache: Dict[str, torch.Tensor], cur: int, bias: torch.Tensor, *,
    policy: KernelPolicy = DEFAULT_POLICY,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. ``cache`` holds ``k`` and ``v`` of shape (B, KV,
    T, hd); this step's K and V are written in place at ``cur``, and the
    same dict is returned. ``bias`` is ``decode_bias(B, T, cur, window)``,
    which carries the reference's ``window`` (the layers of a step share
    it)."""
    dt = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    assert S == 1
    H, hd = cfg.n_heads, cfg.hd
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.full((1,), cur, dtype=torch.int32, device=x.device)
    q = rope(q, pos[None, :], cfg.rope_theta)
    k = rope(k, pos[None, :], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, :, cur] = k[:, 0].to(ck.dtype)
    cv[:, :, cur] = v[:, 0].to(cv.dtype)
    out = ops.decode_attention(q[:, 0].to(ck.dtype), ck, cv, bias,
                               policy=policy)
    y = out.reshape(B, 1, H * hd).to(x.dtype) @ cast(p.wo, dt)
    return y, cache


def decode_cross_attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                           cache: Dict[str, torch.Tensor], *,
                           policy: KernelPolicy = DEFAULT_POLICY
                           ) -> torch.Tensor:
    """Decode-time cross attention against the cached memory K and V
    (``ck``, ``cv``: (B, KV, M, hd)), no mask."""
    dt = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    ck, cv = cache["ck"], cache["cv"]
    q = unflatten(x @ cast(p.c_wq, dt), -1, (H, hd))[:, 0]
    out = ops.decode_attention(q.to(ck.dtype), ck, cv, policy=policy)
    return out.reshape(B, 1, H * hd).to(x.dtype) @ cast(p.c_wo, dt)
