"""smollm-135m [dense]: 30L d=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
Llama-architecture small model [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    vocab=49_152, d_model=576, n_layers=30, n_heads=9, n_kv_heads=3,
    d_ff=1_536, head_dim=64, pattern=("dense",), tie_embeddings=True,
    rope_theta=10_000.0,
)
