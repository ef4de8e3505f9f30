"""StableLM-3B: dense MHA transformer [hf:stabilityai/stablelm-2-1_6b family;
unverified tier].  Full attention -> long_500k skipped (quadratic)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
    shape_skips={"long_500k": "full quadratic attention at 524k context"},
)
