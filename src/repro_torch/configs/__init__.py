"""Architecture registry: the 10 configs and the input-shape sets, the
port's copy of the reference's (``repro.configs``).

``get_config(name)`` returns the ModelConfig; ``input_specs(cfg, shape)``
returns ``torch.empty(..., device='meta')`` stand-ins for every model input
of that (arch x shape) cell: shapes and dtypes, no allocation.

Shapes:
    train_4k     seq 4,096   global_batch 256   -> train_step
    prefill_32k  seq 32,768  global_batch 32    -> prefill (forward)
    decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524,288 global_batch 1     -> serve_step; SSM/hybrid only
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "ALIASES", "SHAPES", "ShapeSpec", "get_config",
           "reduced", "shape_applicable", "input_specs"]

ARCHS = (
    "smollm_135m",
    "starcoder2_7b",
    "gemma3_1b",
    "llama3_405b",
    "llama32_vision_11b",
    "llama4_scout_17b_16e",
    "olmoe_1b_7b",
    "whisper_small",
    "rwkv6_7b",
    "zamba2_1p2b",
)

# published ids -> module names
ALIASES = {
    "smollm-135m": "smollm_135m",
    "starcoder2-7b": "starcoder2_7b",
    "gemma3-1b": "gemma3_1b",
    "llama3-405b": "llama3_405b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "whisper-small": "whisper_small",
    "rwkv6-7b": "rwkv6_7b",
    "zamba2-1.2b": "zamba2_1p2b",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(name, name)}")
    return mod.CONFIG


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny config of the same family (identical pattern block types, GQA
    grouping preserved) for CPU tests: one instance of each distinct block
    type in first-appearance order, two repeats, head dim 16, float32."""
    seen, pat = set(), []
    for bt in cfg.pattern:
        if bt not in seen:
            seen.add(bt)
            pat.append(bt)
    pattern = tuple(pat)
    group = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(n_heads // group, 1)
    n_heads = n_kv * group
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        vocab=256,
        d_model=32 * max(n_heads // 4, 1),
        n_layers=2 * len(pattern),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=64,
        pattern=pattern,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        topk=min(cfg.topk, 2) if cfg.topk else 0,
        moe_dff=32 if cfg.moe_dff else 0,
        shared_expert_dff=32 if cfg.shared_expert_dff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_heads=4 if cfg.ssm_state else 0,
        rwkv_head_dim=16,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_d_model=32 * max(n_heads // 4, 1) if cfg.enc_layers else 0,
        enc_heads=n_heads if cfg.enc_layers else 0,
        enc_d_ff=64 if cfg.enc_layers else 0,
        n_memory_tokens=8 if cfg.n_memory_tokens else 0,
        window=min(cfg.window, 8) if cfg.window else 0,
        attn_chunk=16,
        attn_seq_shard=False,
        attn_head_shard=False,
        attn_probs_bf16=False,
        residual_seq_shard=False,
        grad_accum=1,
        remat="none",
        param_dtype="float32",
        compute_dtype="float32",
    )


def shape_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if the (arch x shape) cell runs; else the documented skip reason."""
    if shape == "long_500k" and not cfg.subquadratic:
        return ("full-attention architecture: 500k dense KV/O(S^2) attention "
                "out of assignment scope (DESIGN.md §Arch-applicability)")
    return None


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, torch.Tensor]:
    """Meta tensors (shape and dtype, no storage) for every model input of
    the cell, as the reference's ``ShapeDtypeStruct``s."""
    sp = SHAPES[shape]
    B, S = sp.batch, sp.seq

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if sp.kind in ("train", "prefill"):
        specs = {"tokens": spec((B, S), torch.int32)}
        if sp.kind == "train":
            specs["targets"] = spec((B, S), torch.int32)
        if cfg.n_memory_tokens and not cfg.has_encoder:
            specs["memory"] = spec((B, cfg.n_memory_tokens, cfg.d_model),
                                   torch.float32)
        if cfg.has_encoder:
            specs["frames"] = spec((B, cfg.n_memory_tokens, cfg.enc_d_model),
                                   torch.float32)
        return specs
    # decode: one new token against a seq-long cache
    return {"tokens": spec((B, 1), torch.int32),
            "cur": spec((), torch.int32)}
