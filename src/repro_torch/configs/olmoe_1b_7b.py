"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    vocab=50_304, d_model=2_048, n_layers=16, n_heads=16, n_kv_heads=16,
    d_ff=1_024, head_dim=128, pattern=("moe",),
    n_experts=64, topk=8, moe_dff=1_024,
    rope_theta=10_000.0, moe_ep=True,
)
