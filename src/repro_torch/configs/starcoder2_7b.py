"""starcoder2-7b [dense]: 32L d=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
GQA + RoPE [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    vocab=49_152, d_model=4_608, n_layers=32, n_heads=36, n_kv_heads=4,
    d_ff=18_432, head_dim=128, pattern=("dense",),
    rope_theta=1_000_000.0,
    mlp_gated=False,
    attn_seq_shard=True,
)
