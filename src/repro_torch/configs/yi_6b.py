"""Yi-6B: llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5000000.0,
    fsdp=True,
    source="arXiv:2403.04652; hf",
    shape_skips={"long_500k": "full quadratic attention at 524k context"},
)
