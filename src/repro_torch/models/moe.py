"""Mixture-of-Experts FFN (llama4-scout 16e top-1 + shared expert; olmoe
64e top-8), ``repro.models.moe``.

Tokens are routed top-K by a float32 softmax router, grouped per expert by
one stable argsort, bucketed into ``(E, C, d)`` with capacity ``C =
ceil(1.25 N K / E)`` rounded up to 128 (tokens past an expert's capacity
drop, in sort order), and run as one batched product a projection. The
order decides which experts are picked and which tokens drop, so both
follow the reference's: its ``top_k`` breaks ties toward the lower index
(here a stable descending sort) and its ``argsort`` is stable.

A Switch-style load-balancing loss is returned alongside. The reference's
expert-parallel variant (``ep=True``) only places experts over a mesh
axis and computes the same function; it is not taken here.

Under data parallelism each entry routes its share of the batch, while
the reference's GSPMD step routes the global batch: the capacity comes
from the global batch's tokens, an expert's slots go to the assignments
in the global batch's order (so an entry's tokens drop after those of the
entries before it), and the aux loss takes the global batch's expert
density. ``MoE.dispatch`` (a ``Dispatch``, set by the training step for
one entry) carries those statistics in; ``None`` routes the tokens given
as the whole batch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import (Initializer, cast, dtype_of, gathered, rejoin,
                     unflatten)

__all__ = ["MoE", "Dispatch", "init_moe", "route", "capacity", "moe_ffn"]


class Dispatch:
    """One entry's share of a data-parallel batch, for one MoE layer:
    ``tokens`` of the global batch (which sets the capacity), ``share``
    (this entry's tokens over the global batch's), ``before`` (E,), the
    assignments to each expert of the entries before this one, and
    ``density`` (E,), the global batch's expert density, or ``None`` (the
    share's own). ``counts`` (E,) records this entry's assignments at the
    last call."""

    def __init__(self, tokens: int, share: float,
                 before: Optional[torch.Tensor] = None,
                 density: Optional[torch.Tensor] = None):
        self.tokens = int(tokens)
        self.share = float(share)
        self.before = before
        self.density = density
        self.counts: Optional[torch.Tensor] = None


class MoE(nn.Module):
    """``router``, ``experts_gate``, ``experts_up``, ``experts_down``; with
    a shared expert also ``shared_gate``, ``shared_up``, ``shared_down``."""

    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.moe_dff, cfg.n_experts
        self.router = ini.normal((d, E), scale=0.02)
        self.experts_gate = ini.normal((E, d, ff))
        self.experts_up = ini.normal((E, d, ff))
        self.experts_down = ini.normal((E, ff, d))
        if cfg.shared_expert_dff:
            sf = cfg.shared_expert_dff
            self.shared_gate = ini.normal((d, sf))
            self.shared_up = ini.normal((d, sf))
            self.shared_down = ini.normal((sf, d))
        self.dispatch: Optional[Dispatch] = None


def init_moe(ini: Initializer, cfg: ModelConfig) -> MoE:
    return MoE(ini, cfg)


def route(p: MoE, xt: torch.Tensor, cfg: ModelConfig):
    """(gate values (N, K) normalized, expert indices (N, K), router
    probabilities (N, E)) for tokens ``xt`` (N, d)."""
    logits = xt.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[:, :cfg.topk]
    expert_idx = order.indices[:, :cfg.topk]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, expert_idx, probs


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """An expert's slots for ``tokens`` routed tokens: ceil(1.25 N K / E)
    rounded up to a multiple of 128 (at least 128)."""
    c = -(-tokens * cfg.topk * 125 // (cfg.n_experts * 100))
    return max(((c + 127) // 128) * 128, 128)


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    dt = dtype_of(cfg.compute_dtype)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.topk
    N = B * S
    xt = x.reshape(N, d)
    gate_vals, expert_idx, probs = route(p, xt, cfg)

    plan = p.dispatch
    # the dry run's count: the dispatch's index arithmetic, gathers and
    # scatters on whole tensors (all-gathers), which DTensor has no rules
    # for, rejoined as replicated DTensors; the experts' products stay
    # sharded
    expert_idx = gathered(expert_idx)
    # Switch aux loss: E * sum_e f_e * P_e
    if plan is None or plan.density is None:
        density = F.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
    else:
        density = plan.density
    aux = E * torch.sum(density * probs.mean(dim=0))
    if plan is not None:  # this share's part of the global batch's term
        aux = aux * plan.share

    C = capacity(N if plan is None else plan.tokens, cfg)
    flat_expert = expert_idx.reshape(-1)                   # (N K,)
    order = torch.argsort(flat_expert, stable=True)
    sorted_e = flat_expert[order]
    experts = torch.arange(E, device=x.device)
    start = torch.searchsorted(sorted_e, experts)          # group starts
    counts = torch.searchsorted(sorted_e, experts, right=True) - start
    kept = torch.clamp(counts, max=C)                      # (E,)
    if plan is not None:
        plan.counts = counts.detach()
        if plan.before is not None:  # the slots the entries before took
            kept = torch.minimum(counts,
                                 torch.clamp(C - plan.before, min=0))
    ar = torch.arange(C, device=x.device)
    slot = torch.clamp(start[:, None] + ar[None, :], 0, N * K - 1)  # (E, C)
    in_cap = ar[None, :] < kept[:, None]
    src = order[slot]                                      # flat assignment id
    token_of = src // K                                    # (E, C) source token
    xs = gathered(xt)[token_of.reshape(-1)].to(dt)
    xs = rejoin(torch.where(in_cap.reshape(-1, 1), xs, 0).reshape(E, C, d),
                xt)

    g = torch.bmm(xs, cast(p.experts_gate, dt))
    u = torch.bmm(xs, cast(p.experts_up, dt))
    y = torch.bmm(F.silu(g) * u, cast(p.experts_down, dt))

    gates_bucket = rejoin(torch.where(
        in_cap, gathered(gate_vals).reshape(-1)[src], 0.0), xt)
    contrib = y.float() * gates_bucket[..., None]
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    out.index_add_(0, token_of.reshape(-1), gathered(contrib).reshape(-1, d))
    out = rejoin(out, xt)

    if cfg.shared_expert_dff:
        sg = xt @ cast(p.shared_gate, dt)
        su = xt @ cast(p.shared_up, dt)
        out = out + ((F.silu(sg) * su) @ cast(p.shared_down, dt)).float()

    return unflatten(out, 0, (B, S)).to(x.dtype), aux
