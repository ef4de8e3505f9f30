"""Model assembly for the dense-attention families: parameters, forward pass,
logits.

Counterpart of ``repro/models/transformer.py``.  The parameters live in an
``nn.Module`` (:class:`Transformer`) that reads like the JAX package's tree:
``params["embed"]``, ``params["layers"][i]["attn"]["wq"]``, ``"final_ln"``,
in its layout (``x @ w``; the fused ``wi`` is (D, 2F)).  The layers are a
Python loop in place of ``lax.scan``.  :func:`params_from_jax` loads the JAX
package's tree (layers stacked on a leading axis), so both packages can
compute with the same weights.

The families this slice carries are the attention-only ones (llama3.2-1b,
h2o-danube-1.8b, stablelm-3b, yi-6b).  MoE, SSM/hybrid, encoder-decoder and
VLM configurations raise ``NotImplementedError``: ROADMAP.md queue 1 item 6.

Training: :func:`loss_fn` runs :func:`forward_train` (gradients enabled,
each layer recomputed in the backward where ``cfg.remat`` is set, as the
reference's ``jax.checkpoint`` of its scan body) and
:func:`chunked_ce_loss` (512 positions at a time, each chunk's logits
recomputed in the backward).  :func:`param_tree` gives the parameters as a
nested dict of tensors (the module's own storage) for the optimizer, the
gradient and the checkpoint.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codec.device import resolve_device
from repro_torch.models import layers as L

_LATER = (("n_experts", "MoE"), ("ssm_state", "SSM/hybrid"),
          ("encoder_decoder", "encoder-decoder (audio)"), ("prefix_embeds", "VLM"))


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


class Params(nn.Module):
    """Named tensors and sub-blocks read as ``p["name"]`` (and ``"name" in
    p``), like the JAX package's parameter dicts."""

    def __getitem__(self, name: str):
        if name in self:
            return getattr(self, name)
        raise KeyError(name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules


class Transformer(Params):
    """The parameters of one attention-family model (uninitialized; see
    :func:`init_params` and :func:`params_from_jax`) on ``device``: ``None``
    means the card, and raises without one."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        for field, family in _LATER:
            if getattr(cfg, field):
                raise NotImplementedError(
                    f"{cfg.name}: the {family} family is not ported yet "
                    "(ROADMAP.md queue 1 item 6)")
        if not cfg.n_heads or cfg.family == "ssm":
            raise NotImplementedError(f"{cfg.name}: attention-free models are not ported yet "
                                      "(ROADMAP.md queue 1 item 6)")
        device = resolve_device(device, "Transformer")
        self.cfg = cfg
        dt = param_dtype(cfg)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)

        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.embed = param(cfg.padded_vocab, d)
        self.layers = nn.ModuleList()
        for _ in range(cfg.n_layers):
            lay = Params()
            lay.ln1 = param(d)
            lay.attn = Params()
            lay.attn.wq = param(d, cfg.n_heads * hd)
            lay.attn.wk = param(d, cfg.n_kv_heads * hd)
            lay.attn.wv = param(d, cfg.n_kv_heads * hd)
            lay.attn.wo = param(cfg.n_heads * hd, d)
            if cfg.d_ff:
                lay.mlp = Params()
                lay.mlp.wi = param(d, 2 * cfg.d_ff)
                lay.mlp.wo = param(cfg.d_ff, d)
                lay.ln2 = param(d)
            self.layers.append(lay)
        self.final_ln = param(d)
        if not cfg.tie_embeddings:
            self.lm_head = param(d, cfg.padded_vocab)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator, device=None) -> Transformer:
    """Random weights as the reference draws them: normal * fan_in^-0.5 for
    every matrix (fan_in d_model, or the rows of an output projection
    ``wo``), ones for the norms.  ``generator`` lies on ``device`` (``None``:
    the card); its numbers are not jax.random's."""
    model = Transformer(cfg, device=device)
    for name, w in model.named_parameters():
        if w.dim() == 1:
            w.fill_(1.0)
            continue
        fan_in = w.shape[0] if name.endswith(".wo") else cfg.d_model
        x = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        w.copy_(x.normal_(generator=generator).mul_(fan_in ** -0.5))
    return model


@torch.no_grad()
def params_from_jax(tree, cfg: ArchConfig, device=None) -> Transformer:
    """The port's module on ``device`` (``None``: the card) from the JAX
    package's parameter tree (arrays the numpy way: layers stacked on a
    leading axis, as ``jax.vmap`` made them)."""
    model = Transformer(cfg, device=device)

    def put(dst: torch.Tensor, src) -> None:
        arr = np.asarray(src, dtype=np.float32)
        if arr.shape != tuple(dst.shape):
            raise ValueError(f"shape {arr.shape} != {tuple(dst.shape)}")
        dst.copy_(torch.tensor(arr))

    put(model.embed, tree["embed"])
    put(model.final_ln, tree["final_ln"])
    if not cfg.tie_embeddings:
        put(model.lm_head, tree["lm_head"])
    stacked = tree["layers"]
    for i, lay in enumerate(model.layers):
        for name in ("ln1", "ln2"):
            if name in lay:
                put(lay[name], stacked[name][i])
        for block in ("attn", "mlp"):
            if block in lay:
                for wname, w in lay[block]._parameters.items():
                    put(w, stacked[block][wname][i])
    return model


def param_tree(model: Transformer) -> dict:
    """The model's tensors as a nested dict (``{"embed", "final_ln",
    "layers": [{"ln1", "attn": {...}, "mlp": {...}, "ln2"}, ...]}``), sharing
    the module's storage; the model functions read either form."""
    def node(mod):
        out = {name: t.data for name, t in mod._parameters.items()}
        for name, sub in mod._modules.items():
            out[name] = [node(m) for m in sub] if isinstance(sub, nn.ModuleList) else node(sub)
        return out

    return node(model)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def ffn_part(p, h, cfg: ArchConfig):
    """Post-mixer FFN residual (dense MLP).  Returns (h, aux); aux is 0 for
    the families this slice carries (it is the MoE balance loss)."""
    if "ln2" in p:
        hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
        if "mlp" in p:
            h = h + L.swiglu_mlp(p["mlp"], hn)
    return h, 0.0


def _block(p, h, cfg: ArchConfig, *, causal: bool):
    """One transformer block (train/prefill form).  Returns (h, aux, caps),
    caps holding the layer's k/v for a serving cache."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    attn_out, (k, v) = L.attention(p["attn"], hn, cfg, causal=causal)
    h = h + attn_out
    h, aux = ffn_part(p, h, cfg)
    return h, aux, {"k": k, "v": v}


def _run_layers(layers, h, cfg, *, causal: bool, capture: bool = False):
    """Every layer in turn.  With ``capture`` also returns the layers' caps
    stacked on a leading axis, as the reference's scan does."""
    aux = 0.0
    caps = []
    for lp in layers:
        h, a, c = _block(lp, h, cfg, causal=causal)
        aux = aux + a
        if capture:
            caps.append(c)
    if not capture:
        return h, aux
    return h, aux, {name: torch.stack([c[name] for c in caps]) for name in ("k", "v")}


# ---------------------------------------------------------------------------
# forward + logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    return params["embed"][tokens.long()].to(compute_dtype(cfg))


@torch.no_grad()
@L.exact_matmuls()
def forward(params, cfg: ArchConfig, tokens):
    """-> (hidden (B, S, D), aux_loss)."""
    h = embed_tokens(params, cfg, tokens)
    h, aux = _run_layers(params["layers"], h, cfg, causal=True)
    return L.rms_norm(h, params["final_ln"], cfg.norm_eps), aux


def forward_train(params, cfg: ArchConfig, tokens):
    """:func:`forward` with gradients: -> (hidden (B, S, D), aux_loss).
    With ``cfg.remat`` each layer keeps only its input for the backward and
    runs again there (``torch.utils.checkpoint``, non-reentrant)."""
    h = embed_tokens(params, cfg, tokens)
    aux = 0.0
    for lp in params["layers"]:
        if cfg.remat:
            h, a = checkpoint(lambda x, lp=lp: _block(lp, x, cfg, causal=True)[:2], h,
                              use_reentrant=False)
        else:
            h, a, _caps = _block(lp, h, cfg, causal=True)
        aux = aux + a
    return L.rms_norm(h, params["final_ln"], cfg.norm_eps), aux


def lm_head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


@L.exact_matmuls()
def logits_for(params, cfg, h):
    """Logits in float32 over the padded vocabulary; the padding columns get
    -1e9."""
    out = L.dense(h, lm_head_weight(params, cfg)).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab_size:
        mask = torch.zeros(cfg.padded_vocab, dtype=torch.float32, device=out.device)
        mask[cfg.vocab_size:] = 1e9
        out = out - mask
    return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce_chunk(hx, w, lx, vocab: int):
    """Summed negative log-likelihood and token count of one chunk."""
    logits = L.dense(hx, w).to(torch.float32)                  # (B, c, V)
    mask = lx >= 0
    lse = torch.logsumexp(logits[..., :vocab], dim=-1)
    gold = torch.gather(logits, -1, lx.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum(), mask.sum()


def chunked_ce_loss(params, cfg: ArchConfig, h, labels, *, chunk: int = 512):
    """Cross-entropy without materializing (B, S, V): ``chunk`` positions at
    a time, each chunk's logits recomputed in the backward.  labels: (B, S),
    -1 = ignore.  Returns (loss_sum, token_count)."""
    s = h.shape[1]
    c = min(chunk, s)
    w = lm_head_weight(params, cfg)
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(0, s, c):
        part, n = checkpoint(_ce_chunk, h[:, i:i + c], w, labels[:, i:i + c],
                             cfg.vocab_size, use_reentrant=False)
        loss = loss + part
        cnt = cnt + n
    return loss, cnt


def loss_fn(params, cfg: ArchConfig, batch, *, aux_weight: float = 0.01):
    """Scalar training loss of a batch dict (``tokens``, ``labels``)."""
    h, aux = forward_train(params, cfg, batch["tokens"])
    loss, cnt = chunked_ce_loss(params, cfg, h, batch["labels"])
    loss = loss / torch.clamp(cnt.to(torch.float32), min=1.0)
    return loss + aux_weight * aux / max(cfg.n_layers, 1)
