"""llama4-scout-17b-a16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    vocab=202_048, d_model=5_120, n_layers=48, n_heads=40, n_kv_heads=8,
    d_ff=8_192, head_dim=128, pattern=("moe",),
    n_experts=16, topk=1, moe_dff=8_192, shared_expert_dff=8_192,
    rope_theta=500_000.0, param_dtype="bfloat16",
    remat="segments", grad_accum=8, opt_factored=True,
    attn_seq_shard=True, attn_probs_bf16=True,
    moe_ep=True,
)
