"""llama3-405b [dense]: 126L d=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.
GQA, 128k vocab [arXiv:2407.21783; unverified]. bf16 params, segment remat."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    vocab=128_256, d_model=16_384, n_layers=126, n_heads=128, n_kv_heads=8,
    d_ff=53_248, head_dim=128, pattern=("dense",),
    rope_theta=500_000.0, param_dtype="bfloat16",
    remat="segments", grad_accum=4, opt_factored=True,
    attn_head_shard=True, attn_probs_bf16=True,
)
