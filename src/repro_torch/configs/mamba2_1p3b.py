"""Mamba2-1.3B: attention-free SSD (state-space duality) [arXiv:2405.21060].
Chunked intra/inter block algorithm; O(1)-state decode -> long_500k runs."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    source="arXiv:2405.21060; unverified",
)
