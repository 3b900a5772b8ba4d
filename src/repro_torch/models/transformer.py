"""Model assembly: the pattern-stacked decoder (all 10 families) and the
optional encoder (whisper), with the forward pass, prefill and one-token
decode (``repro.models.transformer``).

``Transformer`` holds one module a layer in ``blocks``, in the reference's
scan order (layer ``r * len(pattern) + i`` is repeat r of pattern entry i).
zamba2's tied attention block is one module, ``shared``, which every
``shared_attn`` position uses (its entry in ``blocks`` holds an unused
``norm1``, as the reference's does). The
model also holds the ``KernelPolicy`` its attention routes take.

The training knobs, as the reference reads them:

  * ``remat`` (with ``remat_segment``) maps onto ``torch.utils.checkpoint``
    (``use_reentrant=False``) when autograd records: ``"full"`` keeps only
    each repeat's input (a repeat of the pattern at a time, one block for
    a one-entry pattern) and recomputes the repeat in the backward pass;
    ``"segments"`` does so a segment of ``_segment_factor`` repeats at a
    time (about sqrt(repeats)); ``"none"`` keeps every activation. The
    recomputation runs each attention layer's forward again, so a training
    step launches the attention kernel twice a layer. The values are the
    same under every setting;
  * ``grad_accum`` is read only by the dry run's step
    (``launch/dryrun.py`` ``make_train_step``), never by ``train``, as in
    the reference;
  * ``residual_seq_shard`` picks ``layers.shard_batch_seq`` over
    ``shard_batch`` for the residual stream between blocks, as the
    reference does; one controller has no GSPMD, so both return their
    input and the setting changes nothing.

``prefill`` computes the reference's function (the logits of position S-1
and a cache holding positions 0..S-1) in one forward pass that writes each
layer's K and V into the cache, where the reference runs S decode steps;
the SSM layers keep the final state of their full-sequence scans.

Caches are a list with one dict a layer: attention layers hold ``k`` and
``v`` of shape (B, KV, T, hd) in the compute dtype (cross layers also the
memory's ``ck`` and ``cv``, (B, KV, M, hd)), rwkv layers ``shift_t``,
``shift_c`` and ``state``, mamba layers ``conv`` and ``state``.
``decode_step`` updates the cache in place and returns it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import DEFAULT_POLICY, KernelPolicy, resolve_device

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (Initializer, cast, cross_entropy_loss, dtype_of,
                     gated_mlp, init_mlp, init_norm, lookup, rms_norm,
                     shard_batch, shard_batch_seq)

__all__ = ["Block", "Encoder", "Transformer", "init_model", "forward",
           "loss_fn", "encode", "init_cache", "decode_step", "prefill",
           "ATTENTION_CALLS", "attention_calls"]

Cache = List[Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer of type ``btype``: ``norm1``, then by type ``attn``,
    ``norm2`` and ``mlp`` or ``moe`` (dense, local, enc, moe); ``attn``
    with the cross projections, ``norm_c``, ``norm2``, ``mlp`` (cross);
    ``rwkv_t``, ``norm2`` (rwkv); ``mamba`` and, with ``mamba_mlp``,
    ``norm2`` and ``mlp`` (mamba). A ``shared_attn`` block holds only its
    ``norm1``, unused, as in the reference: its layer runs the model's
    ``shared`` block."""

    def __init__(self, ini: Initializer, btype: str, cfg: ModelConfig):
        super().__init__()
        self.btype = btype
        d = cfg.d_model
        self.norm1 = init_norm(ini, d)
        if btype == "shared_attn":
            return
        if btype in ("dense", "local", "enc", "moe"):
            self.attn = attn.init_attention(ini, cfg)
            self.norm2 = init_norm(ini, d)
            if btype == "moe":
                self.moe = moe_mod.init_moe(ini, cfg)
            else:
                self.mlp = init_mlp(ini, d, cfg.d_ff, cfg.mlp_gated)
        elif btype == "cross":
            self.attn = attn.init_attention(ini, cfg, cross=True)
            self.norm_c = init_norm(ini, d)
            self.norm2 = init_norm(ini, d)
            self.mlp = init_mlp(ini, d, cfg.d_ff, cfg.mlp_gated)
        elif btype == "rwkv":
            self.rwkv_t = ssm_mod.init_rwkv(ini, cfg)
            self.norm2 = init_norm(ini, d)
        elif btype == "mamba":
            self.mamba = ssm_mod.init_mamba(ini, cfg)
            if cfg.mamba_mlp:
                self.norm2 = init_norm(ini, d)
                self.mlp = init_mlp(ini, d, cfg.d_ff, cfg.mlp_gated)
        else:
            raise ValueError(btype)


class Encoder(nn.Module):
    """whisper's encoder: ``enc_layers`` bidirectional blocks and
    ``final_norm``."""

    def __init__(self, ini: Initializer, cfg: ModelConfig):
        super().__init__()
        self.blocks = nn.ModuleList(Block(ini, "enc", cfg)
                                    for _ in range(cfg.enc_layers))
        self.final_norm = init_norm(ini, cfg.d_model)


class Transformer(nn.Module):
    """``embed``, ``blocks``, ``final_norm``, ``unembed`` (unless the
    embeddings are tied), ``shared`` (zamba2) and ``encoder`` (whisper).
    ``cfg`` and ``policy`` ride along; ``policy`` routes the attention."""

    def __init__(self, cfg: ModelConfig, ini: Initializer,
                 policy: KernelPolicy = DEFAULT_POLICY):
        super().__init__()
        self.cfg = cfg
        self.policy = policy
        self.embed = ini.normal((cfg.vocab, cfg.d_model), scale=0.02)
        self.final_norm = init_norm(ini, cfg.d_model)
        self.blocks = nn.ModuleList(Block(ini, bt, cfg)
                                    for _ in range(cfg.repeats)
                                    for bt in cfg.pattern)
        if not cfg.tie_embeddings:
            self.unembed = ini.normal((cfg.d_model, cfg.vocab), scale=0.02)
        if "shared_attn" in cfg.pattern:
            self.shared = Block(ini, "dense", cfg)
        if cfg.has_encoder:
            assert cfg.enc_d_model == cfg.d_model, "bridge projection unsupported"
            self.encoder = Encoder(ini, cfg)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, memory=None):
        return forward(self, tokens, memory)


def init_model(cfg: ModelConfig, seed: int = 0, *, device=None,
               policy: KernelPolicy = DEFAULT_POLICY) -> Transformer:
    """A model drawn from a CPU ``torch.Generator`` seeded with ``seed``, on
    ``device`` (the card by default). On ``"meta"`` nothing is drawn or
    allocated: the parameters have shapes and dtypes only (the dry run's
    path at any size)."""
    device = resolve_device(device)
    if device.type == "meta":
        with torch.device("meta"):
            return Transformer(cfg, Initializer(None,
                                                dtype_of(cfg.param_dtype)),
                               policy)
    gen = torch.Generator().manual_seed(int(seed))
    model = Transformer(cfg, Initializer(gen, dtype_of(cfg.param_dtype)),
                        policy)
    return model.to(device)


# ---------------------------------------------------------------------------
# Forward (and prefill: the same pass, writing the caches)
# ---------------------------------------------------------------------------

# A layer's attention calls by block type, as ``_apply_block`` and
# ``_decode_block`` make them: causal and non-causal
# ``ops.prefill_attention`` (the flash_prefill kernel) and
# ``blockwise_attention`` (plain torch: a window or a memory) a prefill,
# ``ops.decode_attention`` (flash_decode) a decode step. A cross layer
# attends to itself, then to its memory; an encoder layer attends to its
# frames both ways; the SSM layers call none.
ATTENTION_CALLS = {"dense": (1, 0, 0, 1), "moe": (1, 0, 0, 1),
                   "shared_attn": (1, 0, 0, 1), "local": (0, 0, 1, 1),
                   "cross": (1, 0, 1, 2), "enc": (0, 1, 0, 0),
                   "mamba": (0, 0, 0, 0), "rwkv": (0, 0, 0, 0)}


def attention_calls(cfg: ModelConfig) -> tuple:
    """(causal, non-causal, blockwise) calls a prefill and decode calls a
    step of ``cfg``'s layers (its encoder's too): ``ATTENTION_CALLS``
    summed."""
    per = [ATTENTION_CALLS[bt] for _ in range(cfg.repeats)
           for bt in cfg.pattern]
    per += [ATTENTION_CALLS["enc"]] * (cfg.enc_layers if cfg.has_encoder
                                       else 0)
    return tuple(sum(r[i] for r in per) for i in range(4))


def _apply_block(model: Transformer, bp: Block, h, positions, memory,
                 aux: Dict[str, Any], cache: Optional[Dict] = None):
    """One layer over the full sequence. With ``cache`` (prefill) the
    layer's K and V (or SSM state) go into it."""
    cfg, eps, policy = model.cfg, model.cfg.norm_eps, model.policy
    btype = bp.btype
    if btype == "shared_attn":
        bp, btype_eff = model.shared, "dense"
    else:
        btype_eff = btype

    if btype_eff in ("dense", "local", "enc", "moe", "cross"):
        window = cfg.window if btype == "local" else 0
        # prefill groups the query heads as the reference's decode steps
        # do (h // G), whatever attn_head_shard says
        y, (k, v) = attn.self_attention(
            bp.attn, rms_norm(h, bp.norm1.scale, eps), cfg, positions,
            causal=btype_eff != "enc", window=window,
            head_shard=None if cache is None else False, policy=policy)
        if cache is not None:
            S = k.shape[1]
            cache["k"][:, :, :S] = k.transpose(1, 2).to(cache["k"].dtype)
            cache["v"][:, :, :S] = v.transpose(1, 2).to(cache["v"].dtype)
        h = h + y
        if btype_eff == "cross":
            if memory is not None:
                mkv = attn.memory_kv(bp.attn, memory, cfg)
                if cache is not None:
                    cache["ck"] = mkv[0].transpose(1, 2).contiguous()
                    cache["cv"] = mkv[1].transpose(1, 2).contiguous()
                h = h + attn.cross_attention(
                    bp.attn, rms_norm(h, bp.norm_c.scale, eps), mkv, cfg)
            # without memory the cache's memory is one zero token, whose
            # cross attention adds zero: h is unchanged
            return h + gated_mlp(bp.mlp, rms_norm(h, bp.norm2.scale, eps), cfg)
        if btype_eff == "moe":
            y, a = moe_mod.moe_ffn(bp.moe, rms_norm(h, bp.norm2.scale, eps),
                                   cfg)
            aux["moe_aux"] = aux.get("moe_aux", 0.0) + a
        else:
            y = gated_mlp(bp.mlp, rms_norm(h, bp.norm2.scale, eps), cfg)
        return h + y
    if btype_eff == "rwkv":
        y, c1 = ssm_mod.rwkv_time_mix(bp.rwkv_t,
                                      rms_norm(h, bp.norm1.scale, eps), cfg)
        h = h + y
        y, c2 = ssm_mod.rwkv_channel_mix(bp.rwkv_t,
                                         rms_norm(h, bp.norm2.scale, eps), cfg)
        if cache is not None:
            cache.update(c1)
            cache.update(c2)
        return h + y
    if btype_eff == "mamba":
        y, c1 = ssm_mod.mamba_mixer(bp.mamba, rms_norm(h, bp.norm1.scale, eps),
                                    cfg)
        if cache is not None:
            cache.update(c1)
        h = h + y
        if cfg.mamba_mlp:
            h = h + gated_mlp(bp.mlp, rms_norm(h, bp.norm2.scale, eps), cfg)
        return h
    raise ValueError(btype)


def _tokens(model: Transformer, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=model.device).long()


def _unembed(model: Transformer, dt: torch.dtype) -> torch.Tensor:
    if model.cfg.tie_embeddings:
        return cast(model.embed, dt).T
    return cast(model.unembed, dt)


def _segment_factor(r: int, hint: int) -> int:
    """Inner segment length for two-level remat: a divisor of r near
    sqrt(r) (or the config hint if it divides r)."""
    if hint and r % hint == 0:
        return hint
    target = max(int(r ** 0.5), 1)
    for delta in range(r):
        for cand in (target + delta, target - delta):
            if 1 <= cand <= r and r % cand == 0:
                return cand
    return 1


def _run_blocks(model: Transformer, blocks, P: int, h, positions, memory,
                moe_aux, caches: Optional[Cache] = None):
    """``blocks`` (repeats of a pattern of ``P``) in order over ``h``;
    ``moe_aux`` plus each repeat's MoE aux loss (summed within the repeat
    first, as the reference's scan carries it)."""
    pin = shard_batch_seq if model.cfg.residual_seq_shard else shard_batch
    for r0 in range(0, len(blocks), P):
        aux: Dict[str, Any] = {}
        for i in range(r0, r0 + P):
            h = pin(h)
            h = _apply_block(model, blocks[i], h, positions, memory, aux,
                             None if caches is None else caches[i])
        if "moe_aux" in aux:
            moe_aux = moe_aux + aux["moe_aux"]
        h = pin(h)
    return h, moe_aux


def _run_stack(model: Transformer, blocks, P: int, h, positions, memory,
               caches: Optional[Cache] = None):
    """The layer stack ``blocks`` (repeats of a pattern of ``P``) over ``h``
    under the config's ``remat``: (the final hidden state, the MoE aux
    loss)."""
    cfg = model.cfg
    moe_aux = torch.zeros((), device=model.device)
    if (cfg.remat == "none" or caches is not None
            or not torch.is_grad_enabled()):
        return _run_blocks(model, blocks, P, h, positions, memory, moe_aux,
                           caches)
    R = len(blocks) // P
    seg = _segment_factor(R, cfg.remat_segment) if cfg.remat == "segments" \
        else 1
    for r0 in range(0, R, seg):
        # the model draws no random numbers: no RNG state to replay
        h, moe_aux = checkpoint(_run_blocks, model,
                                blocks[r0 * P:(r0 + seg) * P], P, h, positions,
                                memory, moe_aux, use_reentrant=False,
                                preserve_rng_state=False)
    return h, moe_aux


def _stack(model: Transformer, tokens, memory, caches: Optional[Cache] = None):
    """The decoder stack over the full sequence: the final hidden state
    (before the final norm) and the MoE aux loss."""
    cfg = model.cfg
    dt = dtype_of(cfg.compute_dtype)
    tokens = _tokens(model, tokens)
    S = tokens.shape[1]
    h = shard_batch(lookup(cast(model.embed, dt), tokens))
    positions = torch.arange(S, device=model.device)
    if memory is not None:
        memory = torch.as_tensor(memory, device=model.device).to(dt)
    return _run_stack(model, list(model.blocks), len(cfg.pattern), h,
                      positions, memory, caches)


def encode(model: Transformer, frames) -> torch.Tensor:
    """Whisper-style encoder over (stub) precomputed frame embeddings."""
    cfg = model.cfg
    enc = model.encoder
    h = torch.as_tensor(frames, device=model.device).to(
        dtype_of(cfg.compute_dtype))
    positions = torch.arange(h.shape[1], device=model.device)
    h, _ = _run_stack(model, list(enc.blocks), 1, h, positions, None)
    return rms_norm(h, enc.final_norm.scale, cfg.norm_eps)


def forward(model: Transformer, tokens, memory=None
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence forward -> (logits in the compute dtype, aux). memory:
    stub modality tokens (B, M, d) for VLM cross-attn, or encoder output
    for whisper."""
    cfg = model.cfg
    dt = dtype_of(cfg.compute_dtype)
    h, moe_aux = _stack(model, tokens, memory)
    h = shard_batch(rms_norm(h, model.final_norm.scale, cfg.norm_eps))
    return shard_batch(h @ _unembed(model, dt)), {"moe_aux": moe_aux}


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor], *,
            total=None):
    """batch: tokens (B,S), targets (B,S), optional mask (B,S), optional
    memory/frames for VLM & whisper. Differentiable: ``launch/train.py``'s
    step takes its gradient. ``total``: for a share of a larger batch, the
    global batch's count of counted tokens (``cross_entropy_loss``)."""
    cfg = model.cfg
    memory = batch.get("memory")
    if cfg.has_encoder and "frames" in batch:
        memory = encode(model, batch["frames"])
    logits, aux = forward(model, batch["tokens"], memory)
    targets = torch.as_tensor(batch["targets"], device=model.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=model.device)
    loss = cross_entropy_loss(logits, targets, mask, total=total)
    if cfg.is_moe:
        loss = loss + 0.01 * aux["moe_aux"] / max(cfg.repeats, 1)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               n_memory: int = 0, *, device=None) -> Cache:
    """The decode cache, one dict a layer, zeros (on the card by
    default)."""
    device = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.hd
    cdt = dtype_of(cfg.compute_dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cdt, device=device)

    def one(btype):
        if btype in ("dense", "local", "moe", "shared_attn"):
            return {"k": zeros(batch, KV, max_len, hd),
                    "v": zeros(batch, KV, max_len, hd)}
        if btype == "cross":
            return {"k": zeros(batch, KV, max_len, hd),
                    "v": zeros(batch, KV, max_len, hd),
                    "ck": zeros(batch, KV, max(n_memory, 1), hd),
                    "cv": zeros(batch, KV, max(n_memory, 1), hd)}
        if btype == "rwkv":
            return ssm_mod.init_rwkv_cache(cfg, batch, device)
        if btype == "mamba":
            return ssm_mod.init_mamba_cache(cfg, batch, device)
        raise ValueError(btype)

    return [one(bt) for _ in range(cfg.repeats) for bt in cfg.pattern]


def _decode_block(model: Transformer, bp: Block, h, cache: Dict, cur: int,
                  biases: Dict[int, torch.Tensor]):
    cfg, eps, policy = model.cfg, model.cfg.norm_eps, model.policy
    btype = bp.btype
    if btype == "shared_attn":
        bp, btype = model.shared, "dense"
    if btype in ("dense", "local", "moe", "cross"):
        window = cfg.window if btype == "local" else 0
        y, _ = attn.decode_self_attention(
            bp.attn, rms_norm(h, bp.norm1.scale, eps), cfg, cache, cur,
            biases[window], policy=policy)
        h = h + y
        if btype == "cross":
            h = h + attn.decode_cross_attention(
                bp.attn, rms_norm(h, bp.norm_c.scale, eps), cfg, cache,
                policy=policy)
            return h + gated_mlp(bp.mlp, rms_norm(h, bp.norm2.scale, eps), cfg)
        if btype == "moe":
            y, _ = moe_mod.moe_ffn(bp.moe, rms_norm(h, bp.norm2.scale, eps),
                                   cfg)
        else:
            y = gated_mlp(bp.mlp, rms_norm(h, bp.norm2.scale, eps), cfg)
        return h + y
    if btype == "rwkv":
        y, c1 = ssm_mod.rwkv_time_mix(bp.rwkv_t,
                                      rms_norm(h, bp.norm1.scale, eps),
                                      cfg, cache)
        h = h + y
        y, c2 = ssm_mod.rwkv_channel_mix(bp.rwkv_t,
                                         rms_norm(h, bp.norm2.scale, eps),
                                         cfg, cache)
        cache.update(c1)
        cache.update(c2)
        return h + y
    if btype == "mamba":
        y, c1 = ssm_mod.mamba_mixer(bp.mamba, rms_norm(h, bp.norm1.scale, eps),
                                    cfg, cache)
        cache.update(c1)
        h = h + y
        if cfg.mamba_mlp:
            h = h + gated_mlp(bp.mlp, rms_norm(h, bp.norm2.scale, eps), cfg)
        return h
    raise ValueError(btype)


def decode_step(model: Transformer, cache: Cache, tokens, cur
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step. tokens: (B, 1); cur: the current length (an int).
    Updates ``cache`` in place (K and V written at ``cur``, SSM states
    replaced) and returns the float32 logits (B, 1, V) and the same
    cache."""
    cfg = model.cfg
    dt = dtype_of(cfg.compute_dtype)
    cur = int(cur)
    tokens = _tokens(model, tokens)
    h = lookup(cast(model.embed, dt), tokens)
    B = tokens.shape[0]
    biases = {}  # one mask a window, shared by the layers
    for i, bp in enumerate(model.blocks):
        window = cfg.window if bp.btype == "local" else 0
        if "k" in cache[i] and window not in biases:
            biases[window] = attn.decode_bias(B, cache[i]["k"].shape[2], cur,
                                              window, model.device)
        h = _decode_block(model, bp, h, cache[i], cur, biases)
    h = rms_norm(h, model.final_norm.scale, cfg.norm_eps)
    return (h @ _unembed(model, dt)).float(), cache


def prefill(model: Transformer, tokens, max_len: int, memory=None):
    """The reference's prefill in one forward pass: returns the float32
    logits of position S-1, (B, 1, V), and a cache of ``max_len`` positions
    holding 0..S-1 (the memory's projections in cross layers)."""
    cfg = model.cfg
    dt = dtype_of(cfg.compute_dtype)
    tokens = _tokens(model, tokens)
    B = tokens.shape[0]
    n_mem = 0 if memory is None else memory.shape[1]
    caches = init_cache(cfg, B, max_len, n_mem, device=model.device)
    h, _ = _stack(model, tokens, memory, caches)
    h = rms_norm(h[:, -1:], model.final_norm.scale, cfg.norm_eps)
    return (h @ _unembed(model, dt)).float(), caches
