"""Attention-free sequence mixers: Mamba2 (SSD, chunked) and RWKV6 (Finch),
``repro.models.ssm``.

Both are O(S) in sequence length with O(1)-per-token decode state. The
reference runs no Pallas kernel here; the loops over time (RWKV) and over
chunks (the SSD state carry) are plain torch loops.

Mamba2: the SSD chunked algorithm (intra-chunk quadratic + inter-chunk state
scan) with scalar-per-head decay A, depthwise causal conv on (x, B, C), and
a gated output.

RWKV6 "Finch": data-dependent per-channel decay w_t = exp(-exp(...)) via a
low-rank projection of the token-shifted input, matrix-valued state S_h
(hd x hd) per head, bonus u for the current token, plus the squared-ReLU
channel mix. Both mixers return their final state, which is the decode
cache after the sequence.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import Initializer, cast, dtype_of

__all__ = ["Mamba", "RWKV", "init_mamba", "init_mamba_cache", "mamba_mixer",
           "init_rwkv", "init_rwkv_cache", "rwkv_time_mix", "rwkv_channel_mix"]

# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

_CONV_K = 4
_SSD_CHUNK = 256


def _mamba_dims(cfg: ModelConfig):
    din = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(din // 64, 1)
    return din, H, din // H, cfg.ssm_state


class Mamba(nn.Module):
    """``in_proj`` (emits [z (din), x (din), B (n), C (n), dt (H)]),
    ``conv_w``, ``A_log``, ``D``, ``dt_bias``, ``out_proj``."""

    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        din, H, _, n = _mamba_dims(cfg)
        self.in_proj = ini.normal((d, 2 * din + 2 * n + H))
        self.conv_w = ini.normal((_CONV_K, din + 2 * n), scale=0.5)
        self.A_log = ini.zeros((H,))
        self.D = ini.ones((H,))
        self.dt_bias = ini.zeros((H,))
        self.out_proj = ini.normal((din, d))


def init_mamba(ini: Initializer, cfg: ModelConfig) -> Mamba:
    return Mamba(ini, cfg)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel K. x: (B,S,C); w: (K,C).
    state: (B, K-1, C) tail of the previous sequence (decode).
    Returns the output and the new tail."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S, :] * w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :]
    return out, xp[:, -(K - 1):, :]


def _ssd_chunked(xh, dt, B, C, A, chunk: int):
    """SSD: y_t = C_t^T sum_{s<=t} (prod decay) B_s (dt_s x_s).

    xh: (Bt, S, H, hd); dt: (Bt, S, H); B, C: (Bt, S, n); A: (H,) negative.
    Returns y (Bt, S, H, hd) and final state (Bt, H, hd, n).
    """
    Bt, S, H, hd = xh.shape
    n = B.shape[-1]
    pad = (-S) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nC = (S + pad) // chunk
    xh = xh.reshape(Bt, nC, chunk, H, hd)
    dt = dt.reshape(Bt, nC, chunk, H)
    B = B.reshape(Bt, nC, chunk, n)
    C = C.reshape(Bt, nC, chunk, n)

    da = dt * A[None, None, None, :]                 # (Bt,nC,c,H) negative
    cum = torch.cumsum(da, dim=2)                    # within-chunk cumulative

    # intra-chunk (quadratic in chunk): L[i,j] = exp(cum_i - cum_j) (i >= j)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (Bt,nC,c,c,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device).tril()
    L = torch.where(mask[None, None, :, :, None], torch.exp(li), 0.0)
    CB = torch.einsum("bkin,bkjn->bkij", C, B)                # (Bt,nC,c,c)
    W = CB[..., None] * L * dt[:, :, None, :, :]              # (Bt,nC,i,j,H)
    y_intra = torch.einsum("bkijh,bkjhd->bkihd", W, xh)

    # inter-chunk: carry state (H, hd, n)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)         # (Bt,nC,c,H)
    chunk_in = torch.einsum("bkch,bkchd,bkcn->bkhdn",
                            dt * decay_to_end, xh, B).float()
    chunk_decay = torch.exp(torch.sum(da, dim=2))             # (Bt,nC,H)

    state = torch.zeros((Bt, H, hd, n), dtype=torch.float32, device=xh.device)
    y_inter = []
    for c in range(nC):
        y_inter.append(torch.einsum("bcn,bhdn,bch->bchd", C[:, c], state,
                                    torch.exp(cum[:, c])))
        state = state * chunk_decay[:, c, :, None, None] + chunk_in[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)
    y = y.reshape(Bt, S + pad, H, hd)[:, :S]
    return y, state


def _ssd_step(state, dt, xh, B, C, A):
    """One token's recurrence: S' = S * exp(dt A) + dt B x^T, y = C . S'.
    state (Bt, H, hd, n); dt (Bt, 1, H); xh (Bt, 1, H, hd); B, C (Bt, 1,
    n). Returns y (Bt, 1, H, hd) and S'."""
    da = torch.exp(dt[:, 0] * A[None, :])                         # (B,H)
    upd = torch.einsum("bh,bhd,bn->bhdn", dt[:, 0], xh[:, 0],
                       B[:, 0].float())
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhdn->bhd", C[:, 0].float(), state)[:, None]
    return y, state


def mamba_mixer(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                decode_cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """x: (B,S,d). Returns (y, new_cache). Cache: conv tail + ssm state."""
    dt_ = dtype_of(cfg.compute_dtype)
    B_, S, d = x.shape
    din, H, hd, n = _mamba_dims(cfg)

    zxbcdt = x @ cast(p.in_proj, dt_)
    z, xin, Bv, Cv, dt = torch.split(zxbcdt, [din, din, n, n, H], dim=-1)
    conv_in = torch.cat([xin, Bv, Cv], dim=-1)
    conv_state = None if decode_cache is None else decode_cache["conv"]
    conv_out, conv_tail = _causal_conv(conv_in, cast(p.conv_w, dt_), conv_state)
    conv_out = F.silu(conv_out)
    xin, Bv, Cv = torch.split(conv_out, [din, n, n], dim=-1)

    A = -torch.exp(p.A_log.float())
    dt = F.softplus(dt.float() + p.dt_bias.float())
    xh = xin.reshape(B_, S, H, hd).float()

    if decode_cache is None:
        y, state = _ssd_chunked(xh, dt, Bv.float(), Cv.float(), A, _SSD_CHUNK)
    else:
        y, state = _ssd_step(decode_cache["state"], dt, xh, Bv, Cv, A)

    y = y + xh * p.D.float()[None, None, :, None]
    y = y.reshape(B_, S, din).to(dt_) * F.silu(z)
    out = y @ cast(p.out_proj, dt_)
    return out, {"conv": conv_tail.float(), "state": state}


def init_mamba_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    din, H, hd, n = _mamba_dims(cfg)
    return {
        "conv": torch.zeros((batch, _CONV_K - 1, din + 2 * n),
                            dtype=torch.float32, device=device),
        "state": torch.zeros((batch, H, hd, n), dtype=torch.float32,
                             device=device),
    }


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

_LORA = 64


class RWKV(nn.Module):
    """The time mix (``time_mix``, ``time_decay_w0``, ``time_decay_a``,
    ``time_decay_b``, ``time_bonus``, ``wr``, ``wk``, ``wv``, ``wg``,
    ``wo``) and the channel mix (``chan_mix``, ``chan_k``, ``chan_v``)."""

    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.time_mix = ini.normal((5, d), scale=0.02)
        self.time_decay_w0 = ini.zeros((d,))
        self.time_decay_a = ini.normal((d, _LORA), scale=0.02)
        self.time_decay_b = ini.normal((_LORA, d), scale=0.02)
        self.time_bonus = ini.zeros((d,))
        self.wr = ini.normal((d, d))
        self.wk = ini.normal((d, d))
        self.wv = ini.normal((d, d))
        self.wg = ini.normal((d, d))
        self.wo = ini.normal((d, d))
        self.chan_mix = ini.normal((2, d), scale=0.02)
        self.chan_k = ini.normal((d, 7 * d // 2))
        self.chan_v = ini.normal((7 * d // 2, d))


def init_rwkv(ini: Initializer, cfg: ModelConfig) -> RWKV:
    return RWKV(ini, cfg)


def _wkv6_scan(r, k, v, w, u, state0):
    """r,k,v: (B,S,H,hd); w: (B,S,H,hd) decays in (0,1); u: (H,hd).
    state: (B,H,hd,hd)   out_t = (S + u*k_t (x) v_t)^T r_t ; S' = w*S + k (x) v
    """
    state = state0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]            # (B,H,hd,hd)
        full = state + u[None, :, :, None] * kv
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, full))
        state = state * wt[..., :, None] + kv
    return torch.stack(outs, dim=1), state


def _shifted(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted one token right: the previous sequence's last token (or
    zeros) first."""
    first = (torch.zeros_like(x[:, :1]) if last is None
             else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def rwkv_time_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[Dict] = None):
    dt_ = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    prev = _shifted(x, None if cache is None else cache["shift_t"])
    mix = p.time_mix.float()

    def lerp(i):
        m = mix[i][None, None, :]
        return (x.float() * (1 - m) + prev.float() * m).to(dt_)

    r = (lerp(0) @ cast(p.wr, dt_)).reshape(B, S, H, hd)
    k = (lerp(1) @ cast(p.wk, dt_)).reshape(B, S, H, hd)
    v = (lerp(2) @ cast(p.wv, dt_)).reshape(B, S, H, hd)
    g = lerp(3) @ cast(p.wg, dt_)
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(x)))
    dd = (lerp(4).float() @ p.time_decay_a.float()) @ p.time_decay_b.float()
    w = torch.exp(-torch.exp(p.time_decay_w0.float()[None, None] + dd))
    w = w.reshape(B, S, H, hd)
    u = p.time_bonus.float().reshape(H, hd)

    state0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
              if cache is None else cache["state"])
    out, state = _wkv6_scan(r.float(), k.float(), v.float(), w, u, state0)
    out = (out.reshape(B, S, d) * F.silu(g.float())).to(dt_)
    y = out @ cast(p.wo, dt_)
    return y, {"shift_t": x[:, -1].float(), "state": state}


def rwkv_channel_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig,
                     cache: Optional[Dict] = None):
    dt_ = dtype_of(cfg.compute_dtype)
    prev = _shifted(x, None if cache is None else cache["shift_c"])
    mix = p.chan_mix.float()

    def lerp(i):
        m = mix[i][None, None, :]
        return (x.float() * (1 - m) + prev.float() * m).to(dt_)

    k = torch.square(F.relu(lerp(0) @ cast(p.chan_k, dt_)))
    y = k @ cast(p.chan_v, dt_)
    return y, {"shift_c": x[:, -1].float()}


def init_rwkv_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    return {
        "shift_t": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "shift_c": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "state": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
    }
