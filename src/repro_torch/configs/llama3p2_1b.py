"""Llama-3.2-1B: small llama3, GQA kv=8, tied embeddings
[hf:meta-llama/Llama-3.2-1B; unverified tier]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=64,
    rope_theta=500000.0,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B; unverified",
    shape_skips={"long_500k": "full quadratic attention at 524k context"},
)
