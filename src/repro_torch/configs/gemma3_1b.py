"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
5:1 local:global attention, 128k rope [hf:google/gemma-3-1b-pt; unverified].
head_dim=256 (gemma3 uses wide heads: H*hd != d_model, handled natively).
The 26-layer 5:1 schedule is expressed as a single repeat of the full-depth
pattern (4 x [5 local + 1 global] + [local, global])."""
from repro_torch.models.config import ModelConfig

_GROUP = ("local", "local", "local", "local", "local", "dense")

CONFIG = ModelConfig(
    name="gemma3-1b",
    vocab=262_144, d_model=1_152, n_layers=26, n_heads=4, n_kv_heads=1,
    d_ff=6_912, head_dim=256, tie_embeddings=True,
    pattern=_GROUP * 4 + ("local", "dense"),
    window=512, rope_theta=1_000_000.0,
    attn_seq_shard=True,
)
