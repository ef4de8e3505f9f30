"""Hymba-1.5B: hybrid-head transformer -- parallel attention + Mamba heads in
every block [arXiv:2411.13676].  Meta-tokens omitted; branch outputs averaged
after per-branch norm (DESIGN.md section 5).  SWA lets long_500k run."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    sliding_window=2048,
    source="arXiv:2411.13676; hf",
)
