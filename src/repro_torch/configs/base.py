"""Architecture configuration system + registry (pure data).

Counterpart of ``repro/configs/base.py``: every assigned architecture is a
frozen ``ArchConfig`` in its own module under ``repro_torch.configs``;
``get(name)`` resolves it, ``cfg.reduced()`` gives the CPU-test variant of
the same family, and ``input_specs(cfg, shape)`` gives the dry-run's inputs
of a shape cell as tensors on the ``meta`` device (the port's stand-in for
``jax.ShapeDtypeStruct``: a shape and a dtype, nothing allocated).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Any

# The four assigned input-shape cells (LM-family: seq_len x global_batch).
SHAPES: dict[str, dict[str, Any]] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int                     # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (fine-grained MoE)
    dense_ff_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- attention extras ---
    sliding_window: int = 0          # 0 => full causal attention
    rope_theta: float = 10000.0
    # --- encoder-decoder / multimodal frontends (stubs per assignment) ---
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 0             # stub frame/patch count for the encoder
    prefix_embeds: int = 0           # VLM: image-patch embeddings prepended
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "float32"     # "bfloat16" for the very large archs
    compute_dtype: str = "bfloat16"  # activations/matmuls (f32 accumulation)
    fsdp: bool = False               # shard params/optimizer over 'data' too
    remat: bool = True               # activation checkpoint each layer
    source: str = ""                 # public-literature citation
    # which shape cells are skipped and why (e.g. quadratic attn @ 500k)
    shape_skips: dict[str, str] = field(default_factory=dict)

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 128) * 128

    @property
    def is_attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs accounting)."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d if self.n_heads else 0
        ffn = 3 * d * self.d_ff if self.d_ff else 0
        moe = 0
        if self.n_experts:
            moe = self.n_experts * 3 * d * self.moe_d_ff + d * self.n_experts
            moe += self.n_shared_experts * 3 * d * self.moe_d_ff
        ssm = 0
        if self.ssm_state:
            di, n, h = self.ssm_d_inner, self.ssm_state, self.ssm_n_heads
            ssm = d * (2 * di + 2 * n + h) + di * d + (di + 2 * n) * self.ssm_conv_width + 3 * h
        per_layer = attn + ffn + moe + ssm
        total = self.n_layers * per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.encoder_decoder:
            enc_per = attn + ffn
            total += self.n_encoder_layers * enc_per + self.n_layers * (attn)  # cross-attn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        routed_all = self.n_layers * self.n_experts * 3 * self.d_model * self.moe_d_ff
        routed_active = self.n_layers * self.top_k * 3 * self.d_model * self.moe_d_ff
        return full - routed_all + routed_active

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict[str, Any] = dict(
            n_layers=2,
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            head_dim=16,
            param_dtype="float32",
            compute_dtype="float32",
            fsdp=False,
            remat=False,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, 4 * self.n_kv_heads // max(self.n_heads, 1))
        if self.n_experts:
            kw["n_experts"] = 8
            kw["top_k"] = min(self.top_k, 2)
            kw["moe_d_ff"] = 32
        if self.ssm_state:
            kw["ssm_state"] = 16
            kw["ssm_head_dim"] = 16
            kw["ssm_chunk"] = 16
        if self.sliding_window:
            kw["sliding_window"] = 32
        if self.encoder_decoder:
            kw["n_encoder_layers"] = 2
            kw["encoder_len"] = 24
        if self.prefix_embeds:
            kw["prefix_embeds"] = 8
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

ARCH_NAMES = [
    "hymba-1.5b",
    "h2o-danube-1.8b",
    "stablelm-3b",
    "llama3.2-1b",
    "yi-6b",
    "whisper-medium",
    "arctic-480b",
    "deepseek-moe-16b",
    "mamba2-1.3b",
    "internvl2-1b",
]

_MODULE_FOR = {n: "repro_torch.configs." + n.replace("-", "_").replace(".", "p") for n in ARCH_NAMES}


def get(name: str) -> ArchConfig:
    if name not in _MODULE_FOR:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(_MODULE_FOR[name])
    return mod.CONFIG


def all_configs() -> dict[str, ArchConfig]:
    return {n: get(n) for n in ARCH_NAMES}


# ---------------------------------------------------------------------------
# dry-run input specs (tensors on the meta device -- never allocates)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape_name: str, *, reduced: bool = False,
                device="meta") -> dict:
    """Stand-ins for every model input of a shape cell, as empty tensors on
    ``device`` (``meta``: shape and dtype only).

    kind='train'   -> {tokens, labels [, frames | image_embeds]}
    kind='prefill' -> {tokens [, frames | image_embeds]}
    kind='decode'  -> {token} (+ cache specs come from the serve module)
    """
    spec = SHAPES[shape_name]
    s, b = spec["seq_len"], spec["global_batch"]
    if reduced:
        s, b = min(s, 64), min(b, 4)
    kind = spec["kind"]
    import torch

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    out: dict[str, Any] = {}
    if kind in ("train", "prefill"):
        out["tokens"] = empty((b, s), torch.int32)
        if kind == "train":
            out["labels"] = empty((b, s), torch.int32)
    else:
        out["token"] = empty((b, 1), torch.int32)
    if cfg.encoder_decoder:
        out["frames"] = empty((b, cfg.encoder_len, cfg.d_model), torch.float32)
    if cfg.prefix_embeds:
        out["image_embeds"] = empty((b, cfg.prefix_embeds, cfg.d_model), torch.float32)
    return out
