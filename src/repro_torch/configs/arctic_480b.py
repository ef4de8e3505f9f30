"""Snowflake Arctic (480B): 128-expert top-2 MoE with a parallel dense-FFN
residual in every layer [hf:Snowflake/snowflake-arctic-base].
bf16 params + FSDP so 480B fits 512 x 16GB (DESIGN.md section 6)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,                # dense residual FFN
    vocab_size=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_ff_residual=True,
    param_dtype="bfloat16",
    fsdp=True,
    source="hf:Snowflake/snowflake-arctic-base; hf",
    shape_skips={"long_500k": "full quadratic attention at 524k context"},
)
