"""Model configuration for the 10 architecture families: the port's copy
of the reference's ``ModelConfig`` and ``ATTN_BLOCKS``, field for field,
with the same ``param_count`` and ``active_param_count``.

One config drives all families through a per-layer *block pattern*: the
layer stack is ``repeats x pattern`` where each pattern entry names a block
type. Families map as:

    dense GQA          ("dense",)
    gemma3 local:global("local",)*5 + ("dense",)
    MoE                ("moe",)           (llama4 adds a shared expert)
    VLM cross-attn     ("dense",)*4 + ("cross",)
    whisper            encoder ("enc",)*L + decoder ("cross",)*L
    rwkv6              ("rwkv",)
    mamba2 hybrid      ("mamba",)*k + ("shared_attn",)  [zamba2: tied attn]

Block types:
  dense       causal GQA attention + gated MLP
  local       windowed causal attention + gated MLP
  cross       self attention + cross attention (encoder memory) + MLP
  enc         bidirectional attention + MLP (encoder only)
  moe         causal GQA attention + mixture-of-experts FFN
  rwkv        RWKV6 time mix + channel mix (attention-free)
  mamba       Mamba2 SSD mixer + gated MLP
  shared_attn like dense but parameters are TIED across repeats (zamba2)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

ATTN_BLOCKS = ("dense", "local", "cross", "enc", "moe", "shared_attn")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    pattern: Tuple[str, ...] = ("dense",)
    head_dim: Optional[int] = None          # default d_model // n_heads
    # attention
    rope_theta: float = 10_000.0
    window: int = 0                          # local attention window (tokens)
    # MoE
    n_experts: int = 0
    topk: int = 0
    moe_dff: int = 0
    shared_expert_dff: int = 0               # llama4 shared expert
    moe_ep: bool = False                     # EP: experts over model axis
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    # RWKV
    rwkv_head_dim: int = 64
    # encoder (whisper) / modality stubs
    enc_layers: int = 0
    enc_d_model: int = 0
    enc_heads: int = 0
    enc_d_ff: int = 0
    n_memory_tokens: int = 0                 # stub vision/audio tokens
    mlp_gated: bool = True                   # False: 2-matrix GELU MLP
    mamba_mlp: bool = True                   # False: mamba blocks are pure mixers
    # numerics / misc
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    logical_batch_axes: Tuple[str, ...] = ("pod", "data")
    # "none" | "full" | "segments": torch.utils.checkpoint over a repeat
    # (or a segment of repeats) while autograd records (transformer.py)
    remat: str = "full"
    remat_segment: int = 0                   # inner segment length (0 = ~sqrt)
    # microbatch accumulation factor: read by the reference's dry run only,
    # never by its train loop; nothing here reads it
    grad_accum: int = 1
    opt_factored: bool = False               # Adafactor-style second moment
    attn_chunk: int = 1024                   # blockwise-attention KV chunk
    attn_seq_shard: bool = False             # sequence-parallel attention
    attn_head_shard: bool = False            # GQA group-parallel attention
    # SP residual stream (RS+AG TP) across a mesh's model axis: no effect on
    # one card until the sharding rules come (ROADMAP A.5.4)
    residual_seq_shard: bool = False
    attn_probs_bf16: bool = False            # bf16 probability tensors
    # sub-quadratic capability flag (long_500k eligibility)
    subquadratic: bool = False

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: {self.n_layers} layers not divisible by pattern {len(self.pattern)}"
        if self.n_heads:
            assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def has_encoder(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return any(b == "moe" for b in self.pattern)

    def param_count(self) -> int:
        """Approximate parameter count N (for 6*N*D model FLOPs)."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d * (1 if self.tie_embeddings else 2)
        per = {}
        nm = 3 if self.mlp_gated else 2
        per["dense"] = per["enc"] = (
            d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            + nm * d * self.d_ff)
        per["local"] = per["shared_attn"] = per["dense"]
        per["cross"] = per["dense"] + d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + self.n_heads * hd * d
        per["moe"] = (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                      + self.n_heads * hd * d
                      + 3 * d * self.moe_dff * self.n_experts
                      + d * self.n_experts
                      + (3 * d * self.shared_expert_dff))
        din = d * self.ssm_expand
        per["mamba"] = (d * din * 2 + din * d + din * (2 * self.ssm_state)
                        + (nm * d * self.d_ff if self.mamba_mlp else 0))
        per["rwkv"] = 4 * d * d + d * d + 2 * d * (7 * d // 2)  # time mix + channel mix
        for b in self.pattern:
            n += per[b] * self.repeats
        if self.has_encoder:
            ed = self.enc_d_model
            n += self.enc_layers * (4 * ed * ed + 2 * ed * self.enc_d_ff)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) for 6*N_active*D."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        inactive = 3 * d * self.moe_dff * (self.n_experts - self.topk)
        return full - inactive * self.repeats * sum(b == "moe" for b in self.pattern)
