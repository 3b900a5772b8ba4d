"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) d_ff=8192 ssm_state=64 —
Mamba2 backbone + SHARED attention block [arXiv:2411.15242; hf].
Pattern: 18 mamba blocks + 1 shared-attn per repeat, 2 repeats = 38 layers;
the attention params are tied across repeats (zamba's defining trick).
Sub-quadratic: long_500k runs (the config's window is 4,096)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    vocab=32_000, d_model=2_048, n_layers=38, n_heads=32, n_kv_heads=32,
    d_ff=8_192, head_dim=64,
    pattern=("mamba",) * 18 + ("shared_attn",),
    ssm_state=64, ssm_heads=32, ssm_expand=2,
    window=4_096, subquadratic=True, mamba_mlp=False,
)
