"""rwkv6-7b [ssm]: 32L d=4096 attention-free, d_ff=14336 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; hf].
Channel mix is RWKV's 3.5x (= 14336 = 7*4096/2, matching the assigned d_ff
exactly). Sub-quadratic: long_500k RUNS for this arch."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    vocab=65_536, d_model=4_096, n_layers=32, n_heads=64, n_kv_heads=64,
    d_ff=14_336, head_dim=64, pattern=("rwkv",), rwkv_head_dim=64,
    subquadratic=True,
)
