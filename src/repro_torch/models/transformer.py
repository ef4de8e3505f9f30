"""Model assembly: parameters, forward pass, logits, loss.

Counterpart of ``repro/models/transformer.py``.  The parameters live in an
``nn.Module`` (:class:`Transformer`) that reads like the JAX package's tree:
``params["embed"]``, ``params["layers"][i]["attn"]["wq"]``, ``"final_ln"``,
in its layout (``x @ w``; the fused ``wi`` is (D, 2F)).  The layers are a
Python loop in place of ``lax.scan``.  :func:`params_from_jax` loads the JAX
package's tree (layers stacked on a leading axis), so both packages can
compute with the same weights.

The port carries every family of the configs: dense attention (llama3.2-1b,
h2o-danube-1.8b, stablelm-3b, yi-6b), MoE (deepseek-moe-16b; arctic-480b,
whose dense FFN runs beside the experts), SSM (mamba2-1.3b), the hybrid
(hymba-1.5b: an attention and a Mamba2 mixer side by side, their outputs
averaged), the audio encoder-decoder (whisper-medium: :func:`encode` runs a
non-causal encoder over stub frame embeddings through ``frontend_proj``, and
each decoder layer cross-attends to its output after the mixer) and the VLM
(internvl2-1b: stub image embeddings through ``frontend_proj``, prepended
to the tokens).

Training (every family): :func:`loss_fn` runs :func:`forward_train`
(gradients enabled, each layer recomputed in the backward where
``cfg.remat`` is set, as the reference's ``jax.checkpoint`` of its scan
body) and
:func:`chunked_ce_loss` (512 positions at a time, each chunk's logits
recomputed in the backward).  :func:`param_tree` gives the parameters as a
nested dict of tensors (the module's own storage) for the optimizer, the
gradient and the checkpoint.

Under a sharding-rules context (serving or training under a mesh, the
parameters ``DTensor``s or the training step's ``sharding.Shard``s)
:func:`embed_tokens`, :func:`logits_for` and :func:`chunked_ce_loss` are
vocab-parallel: a masked local lookup all-reduced over the vocabulary's
mesh dims; local logits gathered whole over them, so every serving rank
holds the whole logits of its batch rows; and the loss from each rank's
logit columns, its logsumexp assembled from the ranks' maxima and sums of
exponentials, so that no rank holds a chunk's whole (B, 512, V) logits.
The encoder-decoder's and the VLM's ``frontend_proj`` is column-parallel:
its output columns come whole over their split before the residual stream.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codec.device import resolve_device
from repro_torch.models import layers as L, sharding as S


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """bfloat16 or float32 as the config says; "float64" for the float64
    gradient checks."""
    return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(cfg.compute_dtype,
                                                                      torch.float32)


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


def has_attention(cfg: ArchConfig) -> bool:
    return bool(cfg.n_heads) and cfg.family != "ssm"


def has_ssm(cfg: ArchConfig) -> bool:
    return bool(cfg.ssm_state) and cfg.family in ("ssm", "hybrid")


class Transformer(Params):
    """The parameters of one model (uninitialized; see :func:`init_params`
    and :func:`params_from_jax`) on ``device``: ``None`` means the card, and
    raises without one.  Each layer holds the blocks the reference's
    ``_init_layer`` makes for the config: ``attn``, ``ssm``, ``moe`` (with
    ``mlp`` beside it where ``dense_ff_residual``) or ``mlp``, and in a
    decoder layer of an encoder-decoder ``cross`` and ``ln_cross``.  The
    encoder-decoder and the VLM have ``frontend_proj`` (D, D); the
    encoder-decoder an ``encoder`` of ``n_encoder_layers`` layers (no
    ``cross``) and its ``final_ln``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        device = resolve_device(device, "Transformer")
        self.cfg = cfg
        dt = param_dtype(cfg)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device), requires_grad=False)

        def block(**shapes):
            blk = Params()
            for name, shape in shapes.items():
                setattr(blk, name, param(*shape))
            return blk

        d, hd = cfg.d_model, cfg.resolved_head_dim

        def attn():
            return block(wq=(d, cfg.n_heads * hd), wk=(d, cfg.n_kv_heads * hd),
                         wv=(d, cfg.n_kv_heads * hd), wo=(cfg.n_heads * hd, d))

        def layer(decoder: bool):
            lay = Params()
            lay.ln1 = param(d)
            if cfg.n_heads:
                lay.attn = attn()
            if has_ssm(cfg):
                di, h = cfg.ssm_d_inner, cfg.ssm_n_heads
                lay.ssm = block(**{"in": (d, L.ssm_in_features(cfg)),
                                   "conv": (cfg.ssm_conv_width, L.ssm_conv_channels(cfg)),
                                   "dt_bias": (h,), "A_log": (h,), "D": (h,), "norm": (di,),
                                   "out": (di, d)})
            if cfg.n_experts:
                e, f = cfg.n_experts, cfg.moe_d_ff
                shapes = {"router": (d, e), "wi": (e, d, 2 * f), "wo": (e, f, d)}
                if cfg.n_shared_experts:
                    fs = cfg.n_shared_experts * f
                    shapes.update(shared_wi=(d, 2 * fs), shared_wo=(fs, d))
                lay.moe = block(**shapes)
                lay.ln2 = param(d)
                if cfg.dense_ff_residual:
                    lay.mlp = block(wi=(d, 2 * cfg.d_ff), wo=(cfg.d_ff, d))
            elif cfg.d_ff:
                lay.mlp = block(wi=(d, 2 * cfg.d_ff), wo=(cfg.d_ff, d))
                lay.ln2 = param(d)
            if decoder and cfg.encoder_decoder:
                lay.cross = attn()
                lay.ln_cross = param(d)
            return lay

        self.embed = param(cfg.padded_vocab, d)
        self.layers = nn.ModuleList([layer(decoder=True) for _ in range(cfg.n_layers)])
        self.final_ln = param(d)
        if not cfg.tie_embeddings:
            self.lm_head = param(d, cfg.padded_vocab)
        if cfg.encoder_decoder or cfg.prefix_embeds:
            self.frontend_proj = param(d, d)
        if cfg.encoder_decoder:
            self.encoder = Params()
            self.encoder.layers = nn.ModuleList(
                [layer(decoder=False) for _ in range(cfg.n_encoder_layers)])
            self.encoder.final_ln = param(d)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator, device=None) -> Transformer:
    """Random weights as the reference draws them: normal * fan_in^-0.5 for
    every matrix, ones for the norms and the SSM's ``D``, zeros for its
    ``dt_bias``, log U[1, 16) for its ``A_log``.  The fan-in is d_model for
    the embedding and the second-to-last dimension for the rest: d_model for
    the input projections (``moe.wi`` (E, D, 2F) too), the rows of an output
    projection (``moe.wo`` (E, F, D): F), the conv's width.  ``generator``
    lies on ``device`` (``None``: the card); its numbers are not
    jax.random's."""
    model = Transformer(cfg, device=device)
    for name, w in model.named_parameters():
        w.copy_(_draw(cfg, name, w.shape, generator, w.device))
    return model


def _draw(cfg: ArchConfig, name: str, shape, generator: torch.Generator, device) -> torch.Tensor:
    """One parameter's float32 values as :func:`init_params` draws them."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    if name.endswith(".dt_bias"):
        x.zero_()
    elif name.endswith(".A_log"):
        x.uniform_(1.0, 16.0, generator=generator).log_()
    elif len(shape) == 1:
        x.fill_(1.0)
    else:
        fan_in = cfg.d_model if name == "embed" else shape[-2]
        x.normal_(generator=generator).mul_(fan_in ** -0.5)
    return x


@torch.no_grad()
def init_leaves(cfg: ArchConfig, generator: torch.Generator, device=None):
    """(key path, tensor) of each parameter in :func:`init_params`' order
    and with its values, one leaf alive at a time: the sharded training
    state keeps a shard of each and drops the rest."""
    device = resolve_device(device, "init_leaves")
    dt = param_dtype(cfg)
    for name, w in Transformer(cfg, device="meta").named_parameters():
        yield tuple(name.split(".")), _draw(cfg, name, w.shape, generator, device).to(dt)


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

    def put_layers(layers, stacked):
        for i, lay in enumerate(layers):
            for name, w in lay._parameters.items():
                put(w, stacked[name][i])
            for block, mod in lay._modules.items():
                for wname, w in mod._parameters.items():
                    put(w, stacked[block][wname][i])

    put(model.embed, tree["embed"])
    put(model.final_ln, tree["final_ln"])
    if not cfg.tie_embeddings:
        put(model.lm_head, tree["lm_head"])
    if "frontend_proj" in model:
        put(model.frontend_proj, tree["frontend_proj"])
    put_layers(model.layers, tree["layers"])
    if "encoder" in model:
        put_layers(model.encoder.layers, tree["encoder"]["layers"])
        put(model.encoder.final_ln, tree["encoder"]["final_ln"])
    return model


def param_tree(model: Transformer) -> dict:
    """The model's tensors as a nested dict (``{"embed", "final_ln",
    "layers": [{"ln1", "attn": {...}, "mlp": {...}, "ln2"}, ...]}``, and
    ``frontend_proj`` and ``encoder: {"layers": [...], "final_ln"}`` where
    the model has them), sharing
    the module's storage; the model functions read either form."""
    def node(mod):
        out = {name: t.data for name, t in mod._parameters.items()}
        for name, sub in mod._modules.items():
            out[name] = [node(m) for m in sub] if isinstance(sub, nn.ModuleList) else node(sub)
        return out

    return node(model)


def param_specs(cfg: ArchConfig) -> dict:
    """The parameter tree (:func:`param_tree`'s layout) as tensors on the
    ``meta`` device: shapes and dtypes, nothing allocated and nothing
    drawn -- the reference's ``jax.eval_shape`` of ``init_params``."""
    return param_tree(Transformer(cfg, device="meta"))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

# positions a dense FFN takes at a time outside autograd (a long prefill)
FFN_CHUNK = 65536


def ffn_part(p, h, cfg: ArchConfig):
    """Post-mixer FFN residual (dense MLP and/or MoE).  Returns (h, aux), aux
    the MoE's balance loss (0.0 without experts).  Outside autograd a dense
    FFN over more than FFN_CHUNK positions runs FFN_CHUNK of them at a time
    (it is position-wise): a 524288-token prefill never holds its whole
    (B, S, 2F) product and float32 gate (14.5 GB each for
    h2o-danube-1.8b)."""
    aux = 0.0
    if "ln2" in p and "moe" not in p and h.shape[1] > FFN_CHUNK \
            and not torch.is_grad_enabled():
        out = torch.empty_like(h)
        for i in range(0, h.shape[1], FFN_CHUNK):
            out[:, i:i + FFN_CHUNK] = ffn_part(p, h[:, i:i + FFN_CHUNK], cfg)[0]
        return out, aux
    if "ln2" in p:
        hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
        ff = None
        if "moe" in p:
            ff, aux = L.moe_ffn(p["moe"], hn, cfg)
        if "mlp" in p:
            mlp = L.swiglu_mlp(p["mlp"], hn)
            ff = mlp if ff is None else ff + mlp
        h = h + ff
    return h, aux


def _block(p, h, cfg: ArchConfig, *, causal: bool, enc_out=None):
    """One transformer block (train/prefill form).  Returns (h, aux, caps),
    caps holding what the layer's serving cache needs: k/v, the SSM's final
    state and conv tail, the cross-attention's k/v (``cross_k``,
    ``cross_v``)."""
    caps = {}
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    mix = None
    if has_attention(cfg):
        mix, (caps["k"], caps["v"]) = L.attention(p["attn"], hn, cfg, causal=causal)
    if "ssm" in p:
        ssm_out, (caps["state"], caps["conv"]) = L.mamba2(p["ssm"], hn, cfg, return_state=True)
        # hybrid: parallel heads, outputs averaged (Hymba)
        mix = ssm_out if mix is None else 0.5 * (mix + ssm_out)
    h = h + mix
    if enc_out is not None and "cross" in p:
        hn = L.rms_norm(h, p["ln_cross"], cfg.norm_eps)
        kv = L.cross_kv(p["cross"], enc_out, cfg)
        caps["cross_k"], caps["cross_v"] = kv
        out, _ = L.attention(p["cross"], hn, cfg, causal=False, kv_override=kv)
        h = h + out
    h, aux = ffn_part(p, h, cfg)
    return h, aux, caps


def _run_layers(layers, h, cfg, *, causal: bool, enc_out=None, capture: bool = False,
                capture_from: int = 0):
    """Every layer in turn.  With ``capture`` also returns the layers' caps
    stacked on a leading axis, as the reference's scan does; each layer's
    K/V are kept from position ``capture_from`` of ``h`` on (a prefill
    keeps only what its cache holds), copied, so each layer's whole K/V
    are freed before the next layer runs."""
    aux = 0.0
    caps = []
    for lp in layers:
        h, a, c = _block(lp, h, cfg, causal=causal, enc_out=enc_out)
        aux = aux + a
        if capture:
            if capture_from:
                c.update({nm: c[nm][:, capture_from:].clone() for nm in ("k", "v") if nm in c})
            caps.append(c)
    if not capture:
        return h, aux
    return h, aux, {name: torch.stack([c[name] for c in caps]) for name in caps[0]}


def _run_layers_train(layers, h, cfg, *, causal: bool, enc_out=None):
    """:func:`_run_layers` with gradients.  With ``cfg.remat`` each layer
    keeps only its inputs for the backward and runs again there
    (``torch.utils.checkpoint``, non-reentrant, under the forward's
    sharding rules), as the reference's ``jax.checkpoint`` of its scan
    body."""
    aux = 0.0
    for lp in layers:
        if cfg.remat:
            h, a = checkpoint(lambda x, e, lp=lp: _block(lp, x, cfg, causal=causal,
                                                         enc_out=e)[:2],
                              h, enc_out, use_reentrant=False,
                              context_fn=S.recompute_context)
        else:
            h, a, _caps = _block(lp, h, cfg, causal=causal, enc_out=enc_out)
        aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# forward + logits
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens):
    """The tokens' rows of ``embed`` in the compute dtype.  Under a mesh
    vocab-parallel: each rank looks up the tokens its rows hold (zeros for
    the rest) and the rows are all-reduced over the mesh dims the
    vocabulary is split on -- a sum of one row and zeros, exact."""
    w, lay = S.weight(params["embed"], keep=(0,))
    v0, v1 = S.chunk_range(cfg.padded_vocab, lay[0])
    if (v0, v1) == (0, cfg.padded_vocab):
        return w[tokens.long()].to(compute_dtype(cfg))
    ids = tokens.long() - v0
    inside = (ids >= 0) & (ids < v1 - v0)
    if v1 > v0:
        rows = w[ids.clamp(0, v1 - v0 - 1)].to(compute_dtype(cfg))
    else:                                          # no rows of the vocabulary here
        rows = w.new_zeros(tuple(ids.shape) + (w.shape[1],), dtype=compute_dtype(cfg))
    return S.all_reduce(torch.where(inside[..., None], rows, 0), lay[0])


def _inputs(params, cfg: ArchConfig, tokens, frames, image_embeds, run_layers):
    """The decoder's input (B, S', D) -- the VLM's projected prefix before
    the token embeddings -- and the encoder's output (or None).  With the
    sequence split over ``act_seq`` (``sharding.seq_split``, the
    long-context prefill; ``tokens`` and ``image_embeds`` whole) only this
    rank's positions [lo, hi) of the P + S: the prefix rows [lo, min(hi,
    P)) through ``frontend_proj``, the token rows [max(lo - P, 0), hi - P)
    embedded; a part the rank holds none of is not computed."""
    npre = image_embeds.shape[1] if cfg.prefix_embeds and image_embeds is not None else 0
    split = S.seq_split()
    if split is not None:
        lo, hi = split[1:3]
        tokens = tokens[:, max(lo - npre, 0):max(hi - npre, 0)]
        if npre:
            image_embeds = image_embeds[:, min(lo, npre):min(hi, npre)]
    parts = []
    if npre and image_embeds.shape[1]:
        parts.append(L.column_whole(image_embeds.to(compute_dtype(cfg)),
                                    params["frontend_proj"], cfg.d_model))
    if tokens.shape[1] or not parts:
        parts.append(embed_tokens(params, cfg, tokens))
    h = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    enc_out = None
    if cfg.encoder_decoder:
        enc_out = _encode(params, cfg, frames, run_layers)
    return h, enc_out


def _encode(params, cfg: ArchConfig, frames, run_layers):
    """The encoder's output (B, T, D).  With the sequence split over
    ``act_seq`` (the long-context prefill) this rank runs its frames [f0,
    f1) of the T, in ``sharding.member_range``'s chunks (the reference's
    ``_run_layers`` constrains the encoder's activations over ``act_seq``):
    the non-causal attention reads every frame's K/V, gathered whole, and
    the output is gathered whole over ``act_seq``, as every decoder rank's
    cross-attention reads all of it."""
    split = S.seq_split()
    t = frames.shape[1]
    if split is None:
        return _encoder_layers(params, cfg, frames, run_layers)
    i = split[0]
    if S.member_range(t, i, S.mesh_size((i,)) - 1)[0] >= t:
        raise ValueError(f"{t} frames leave the last of the {S.mesh_size((i,))} members of "
                         f"act_seq without a frame")
    f0, f1 = S.member_range(t, i, S.coordinate(i))
    with S.sequence(t):
        h = _encoder_layers(params, cfg, frames[:, f0:f1], run_layers)
    return S.gather(h, 1, (i,), t)


def _encoder_layers(params, cfg: ArchConfig, frames, run_layers):
    enc = params["encoder"]
    h = L.column_whole(frames.to(compute_dtype(cfg)), params["frontend_proj"], cfg.d_model)
    h, _ = run_layers(enc["layers"], h, cfg, causal=False)
    return L.rms_norm(h, enc["final_ln"], cfg.norm_eps)


@torch.no_grad()
@L.exact_matmuls()
def encode(params, cfg: ArchConfig, frames):
    """Whisper's encoder over stub frame embeddings (B, T, D): through
    ``frontend_proj``, the non-causal encoder layers and its final norm."""
    return _encode(params, cfg, frames, _run_layers)


@torch.no_grad()
@L.exact_matmuls()
def forward(params, cfg: ArchConfig, tokens, *, frames=None, image_embeds=None):
    """-> (hidden (B, S', D), aux_loss); S' includes any VLM prefix."""
    h, enc_out = _inputs(params, cfg, tokens, frames, image_embeds, _run_layers)
    h, aux = _run_layers(params["layers"], h, cfg, causal=True, enc_out=enc_out)
    return L.rms_norm(h, params["final_ln"], cfg.norm_eps), aux


def forward_train(params, cfg: ArchConfig, tokens, *, frames=None, image_embeds=None):
    """:func:`forward` with gradients: -> (hidden (B, S', D), aux_loss),
    each layer of the encoder and the decoder recomputed in the backward
    where ``cfg.remat`` is set.  The MoE's balance loss comes back summed
    over the layers."""
    h, enc_out = _inputs(params, cfg, tokens, frames, image_embeds, _run_layers_train)
    h, aux = _run_layers_train(params["layers"], h, cfg, causal=True, enc_out=enc_out)
    return L.rms_norm(h, params["final_ln"], cfg.norm_eps), aux


def head_weight(params, cfg):
    """The output projection's local columns (D, V / n) -- ``embed``'s rows
    transposed where tied -- and the mesh dims the vocabulary is split
    over (``()`` whole)."""
    key, col = ("embed", 0) if cfg.tie_embeddings else ("lm_head", 1)
    w, lay = S.weight(params[key], keep=(col,))
    return (w.T if cfg.tie_embeddings else w), S.members(lay[col])


@L.exact_matmuls()
def logits_for(params, cfg, h):
    """Logits in float32 over the padded vocabulary; the padding columns get
    -1e9."""
    w, dims = head_weight(params, cfg)
    # under a mesh vocab-parallel: this rank's columns, gathered whole
    out = S.gather(L.dense(S.enter(h, dims), w), -1, dims, cfg.padded_vocab).to(torch.float32)
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
    logits = L.dense(hx, w)
    logits = logits.to(L.acc_dtype(logits.dtype))              # (B, c, V)
    mask = lx >= 0
    lse = torch.logsumexp(logits[..., :vocab], dim=-1)
    gold = torch.gather(logits, -1, lx.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum(), mask.sum()


def _ce_chunk_split(hx, w, lx, vocab: int, v0: int, dims):
    """:func:`_ce_chunk` on this rank's logit columns [v0, v0 + w.shape[1])
    of a vocabulary split over mesh ``dims``: the padding columns (from
    ``vocab``) masked in the rank's own range, the logsumexp from the
    ranks' maxima and sums of exponentials, the gold logit from the rank
    that holds the label's column.  ``hx`` enters the split work, so its
    cotangent is summed over ``dims``."""
    logits = L.dense(S.enter(hx, dims), w)
    logits = logits.to(L.acc_dtype(logits.dtype))              # (B, c, V / n)
    cols = v0 + torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols < vocab, logits, float("-inf"))
    mask = lx >= 0
    m = S.all_reduce_max(logits.detach().amax(dim=-1), dims)
    lse = m + torch.log(S.all_reduce(torch.exp(logits - m[..., None]).sum(-1), dims))
    ids = lx.clamp(min=0).long() - v0
    inside = (ids >= 0) & (ids < logits.shape[-1])
    gold = torch.gather(logits, -1, ids.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
    gold = S.all_reduce(torch.where(inside, gold, 0.0), dims)
    nll = torch.where(mask, lse - gold, 0.0)
    return nll.sum(), mask.sum()


def chunked_ce_loss(params, cfg: ArchConfig, h, labels, *, chunk: int = 512):
    """Cross-entropy without materializing (B, S, V): ``chunk`` positions at
    a time, each chunk's logits recomputed in the backward.  labels: (B, S),
    -1 = ignore.  Returns (loss_sum, token_count).  Under a mesh each rank
    computes its vocabulary columns' share (:func:`_ce_chunk_split`)."""
    s = h.shape[1]
    c = min(chunk, s)
    w, dims = head_weight(params, cfg)
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    if dims:
        v0, _ = S.chunk_range(cfg.padded_vocab, dims)
    for i in range(0, s, c):
        if dims:
            part, n = checkpoint(_ce_chunk_split, h[:, i:i + c], w, labels[:, i:i + c],
                                 cfg.vocab_size, v0, dims, use_reentrant=False,
                                 context_fn=S.recompute_context)
        else:
            part, n = checkpoint(_ce_chunk, h[:, i:i + c], w, labels[:, i:i + c],
                                 cfg.vocab_size, use_reentrant=False)
        loss = loss + part
        cnt = cnt + n
    return loss, cnt


def loss_fn(params, cfg: ArchConfig, batch, *, aux_weight: float = 0.01):
    """Scalar training loss of a batch dict (``tokens``, ``labels`` [,
    ``frames``, ``image_embeds``]); the VLM's prefix positions take no
    loss."""
    h, aux = forward_train(params, cfg, batch["tokens"], frames=batch.get("frames"),
                           image_embeds=batch.get("image_embeds"))
    if cfg.prefix_embeds:
        h = h[:, cfg.prefix_embeds:]
    loss, cnt = chunked_ce_loss(params, cfg, h, batch["labels"])
    loss = loss / torch.clamp(cnt.to(torch.float32), min=1.0)
    return loss + aux_weight * aux / max(cfg.n_layers, 1)
