"""InternVL2-1B backbone (Qwen2-0.5B-style LLM) [arXiv:2404.16821].
InternViT frontend is a STUB per assignment -- input_specs supplies
(B, 256, 896) patch embeddings prepended to the text sequence."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    head_dim=64,
    prefix_embeds=256,
    tie_embeddings=True,
    source="arXiv:2404.16821; hf",
    shape_skips={"long_500k": "full quadratic attention at 524k context"},
)
