"""whisper-small [audio]: enc-dec, 12L+12L d=768 12H d_ff=3072 vocab=51865
[arXiv:2212.04356; unverified].
The conv/audio frontend is a STUB: input_specs() supplies precomputed frame
embeddings (B, 1500, 768) — the output shape of whisper's conv stack."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    vocab=51_865, d_model=768, n_layers=12, n_heads=12, n_kv_heads=12,
    d_ff=3_072, head_dim=64, pattern=("cross",),
    enc_layers=12, enc_d_model=768, enc_heads=12, enc_d_ff=3_072,
    n_memory_tokens=1_500,
    mlp_gated=False,
)
