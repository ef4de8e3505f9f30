"""Whisper-medium backbone: 24L encoder + 24L decoder, d=1024, MHA
[arXiv:2212.04356].  Conv/mel frontend is a STUB per assignment --
input_specs supplies (B, 1500, 1024) precomputed frame embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    encoder_decoder=True,
    n_encoder_layers=24,
    encoder_len=1500,
    source="arXiv:2212.04356; unverified",
    shape_skips={"long_500k": "full quadratic attention at 524k context"},
)
