"""DeepSeekMoE-16B: fine-grained MoE, 2 shared + 64 routed experts top-6
[arXiv:2401.06066].  Homogeneous layers (paper's dense layer-0 simplification
noted in DESIGN.md section 5)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,                    # no dense FFN; shared experts play that role
    vocab_size=102400,
    head_dim=128,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    fsdp=True,
    source="arXiv:2401.06066; hf",
    shape_skips={"long_500k": "full quadratic attention at 524k context"},
)
