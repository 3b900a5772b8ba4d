"""llama-3.2-vision-11b [vlm]: 40L d=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attn image layers every 5th [hf:meta-llama/
Llama-3.2-11B-Vision; unverified].
The vision frontend is a STUB: input_specs() supplies precomputed patch
embeddings (B, 6400, d) = 4 tiles x 1600 patches, already projected."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    vocab=128_256, d_model=4_096, n_layers=40, n_heads=32, n_kv_heads=8,
    d_ff=14_336, head_dim=128,
    pattern=("dense", "dense", "dense", "dense", "cross"),
    n_memory_tokens=6_400, rope_theta=500_000.0,
)
