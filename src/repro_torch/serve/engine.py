"""Serving engine: prefill + single-token decode with KV and SSM state
caches.

Counterpart of ``repro/serve/engine.py``.  Cache modes:
  'dense'      -- K/V slabs (L, B, W, Hkv, hd) in the compute dtype
  'compressed' -- SZx-planes K/V: per (position, kv-head) block of head_dim
                  values -> mu (f32) + sexp (int8) + P uint8 planes, through
                  ``PlanesCodec`` (the planes kernels on the card)

Sliding-window archs use a ring buffer of W = window slots (slot = pos % W)
with an absolute-position array (``slot_pos``) for masking.  SSM and hybrid
archs carry O(1) state per layer: the SSD state (B, H, N, hp) in float32 and
the conv's last W-1 inputs (B, W-1, CC) in the activation dtype.  The
encoder-decoder keeps the cross-attention's K/V, (L, B, T, Hkv, hd) in the
compute dtype, in ``cache["cross"]`` beside the layers' slabs: written once
by the prefill and read-only after, dense in both cache modes, as the
reference keeps them.  The VLM's prefix positions are cached as the tokens'
are.

Where the port differs from the reference:
  - the cache is updated in place: :func:`prefill` builds it, and
    :func:`decode_step` writes the new token's slot into the slabs and
    returns the same dict (the reference returns new arrays);
  - ``cache["pos"]`` is a Python int;
  - the chunked decode attention covers a ragged last chunk.  The
    reference takes ``w // chunk`` chunks and so never reads the newest
    ``w % chunk`` slots when W > DECODE_CHUNK (compressed) or W > 2 *
    DECODE_CHUNK (dense); ROADMAP.md section 3.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.codec.device import DeviceEncoding, resolve_device
from repro_torch.core.codec.planes_codec import PlanesCodec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.sharding import rules_active

NEG_INF = -1e30
DECODE_CHUNK = 2048


def _reduce_scores(s):
    """The reference's cast of the decode scores through bf16 under a
    sharding-rules context (there it halves the wire bytes of the
    cross-shard sum of head_dim-partial scores); outside one, ``s`` as it
    is."""
    if not rules_active():
        return s
    return s.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# channel-block SZx-planes helpers (block = head_dim values of one position)
# ---------------------------------------------------------------------------

def _kv_encode(x, num_planes: int):
    """x: (..., hd) -> (mu f32, sexp int8, planes uint8 (P, ..., hd)): the
    head_dim axis is the block; sexp is clipped to int8 for the cache slab."""
    enc = PlanesCodec(num_planes).encode_blocks_device(x.to(torch.float32))
    enc = enc.replace(sexp=torch.clamp(enc["sexp"], -127, 127).to(torch.int8))
    return enc["mu"], enc["sexp"], enc["planes"]


def _kv_decode(mu, sexp, planes, dtype):
    """Inverse of :func:`_kv_encode`, through the same ``DeviceEncoding``
    record and ``PlanesCodec.decode_encoding``."""
    codec = PlanesCodec(planes.shape[0])
    enc = DeviceEncoding.make("szx-planes", {"mu": mu, "sexp": sexp, "planes": planes},
                              num_planes=planes.shape[0])
    return codec.decode_encoding(enc).to(dtype)


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def cache_window(cfg: ArchConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def make_cache(cfg: ArchConfig, batch: int, seq_len: int, *, kv_mode: str = "dense",
               num_planes: int = 1, dtype=torch.bfloat16, device=None) -> dict:
    """Zero-initialized cache on ``device`` (default the card): K/V slabs
    for the attention families, state and conv slabs for the SSM ones, the
    cross-attention's K/V for the encoder-decoder; an attention-free
    model's ``slot_pos`` has one slot."""
    if kv_mode not in ("dense", "compressed"):
        raise ValueError(f"unknown kv_mode {kv_mode!r}")
    if device is None:
        device = resolve_device(None, "make_cache")
    w = cache_window(cfg, seq_len)
    hd, nl, hkv = cfg.resolved_head_dim, cfg.n_layers, cfg.n_kv_heads
    lay = {}
    attn = T.has_attention(cfg)
    for nm in ("k", "v") if attn else ():
        if kv_mode == "dense":
            lay[nm] = torch.zeros((nl, batch, w, hkv, hd), dtype=dtype, device=device)
        else:
            lay[nm + "mu"] = torch.zeros((nl, batch, w, hkv), dtype=torch.float32, device=device)
            lay[nm + "sexp"] = torch.zeros((nl, batch, w, hkv), dtype=torch.int8, device=device)
            lay[nm + "pl"] = torch.zeros((nl, num_planes, batch, w, hkv, hd), dtype=torch.uint8,
                                         device=device)
    if T.has_ssm(cfg):
        lay["state"] = torch.zeros((nl, batch, cfg.ssm_n_heads, cfg.ssm_state, cfg.ssm_head_dim),
                                   dtype=torch.float32, device=device)
        lay["conv"] = torch.zeros((nl, batch, cfg.ssm_conv_width - 1, L.ssm_conv_channels(cfg)),
                                  dtype=dtype, device=device)
    cache = {"pos": 0,
             "slot_pos": torch.full((w if attn else 1,), -1, dtype=torch.int32, device=device),
             "layers": lay}
    if cfg.encoder_decoder:
        cache["cross"] = {nm: torch.zeros((nl, batch, cfg.encoder_len, hkv, hd), dtype=dtype,
                                          device=device) for nm in ("k", "v")}
    return cache


def cache_specs(cfg: ArchConfig, batch: int, seq_len: int, **kw) -> dict:
    """:func:`make_cache`'s tree on the ``meta`` device (nothing
    allocated), with ``pos`` a 0-d int32 tensor as in the reference's
    ``jax.eval_shape`` of its ``make_cache``."""
    cache = make_cache(cfg, batch, seq_len, device="meta", **kw)
    cache["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return cache


def cache_nbytes(cache: dict) -> int:
    """Bytes of the cache's slabs: the layers' K/V, SSM state and conv, and
    the cross-attention's K/V."""
    return sum(t.numel() * t.element_size()
               for part in ("layers", "cross") for t in cache.get(part, {}).values())


def fill_cache(cache: dict, k, v, *, kv_mode: str = "dense", num_planes: int = 1) -> dict:
    """Write a prefill's K/V (L, B, S, Hkv, hd) into a fresh cache: the last
    min(W, S) positions, at slot pos % W; then pos = S.  Compressed caches
    get one encode over all layers for K and one for V."""
    lay = cache["layers"]
    w = cache["slot_pos"].shape[0]
    s = k.shape[2]
    take = min(w, s)
    dev = cache["slot_pos"].device
    src_pos = torch.arange(s - take, s, device=dev)
    slots = src_pos % w
    k_t, v_t = k[:, :, s - take:], v[:, :, s - take:]
    if kv_mode == "dense":
        lay["k"][:, :, slots] = k_t.to(lay["k"].dtype)
        lay["v"][:, :, slots] = v_t.to(lay["v"].dtype)
    else:
        for nm, t in (("k", k_t), ("v", v_t)):
            mu, sexp, pl = _kv_encode(t, num_planes)         # pl: (P, L, B, take, Hkv, hd)
            lay[nm + "mu"][:, :, slots] = mu
            lay[nm + "sexp"][:, :, slots] = sexp
            lay[nm + "pl"][:, :, :, slots] = pl.movedim(0, 1)
    cache["pos"] = s
    slot_pos = torch.full((w,), -1, dtype=torch.int32, device=dev)
    slot_pos[slots] = src_pos.to(torch.int32)
    cache["slot_pos"] = slot_pos
    return cache


# ---------------------------------------------------------------------------
# decode attention over a (possibly compressed, possibly ring) cache slab
# ---------------------------------------------------------------------------

def _mask(s, slot_pos, qpos: int, window: int):
    valid = (slot_pos >= 0) & (slot_pos <= qpos)
    if window:
        valid &= qpos - slot_pos < window
    return torch.where(valid[None, None, None, :], s, NEG_INF)


def _slab_attend(q, kslab, vslab, slot_pos, qpos: int, *, window: int):
    """q: (B,1,Hq,hd); slabs: (B,W,Hkv,hd); slot_pos: (W,) absolute
    positions.  Single-shot masked attention, float32 scores and p @ v."""
    b, _, hq, hd = q.shape
    hkv = kslab.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kslab.to(torch.float32)) / math.sqrt(hd)
    s = _mask(_reduce_scores(s), slot_pos, qpos, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vslab.to(torch.float32))
    out = out / torch.clamp(p.sum(-1)[..., None], min=1e-30)
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _chunks(w: int, chunk: int) -> list[slice]:
    """Slices of ``chunk`` slots covering W; the last may be short."""
    return [slice(i, i + chunk) for i in range(0, w, chunk)]


def _chunked_slab_attend(q, chunks, qpos: int, *, window: int):
    """Online-softmax loop over ``chunks`` of the cache: (k (B,c,Hkv,hd),
    v, slot_pos (c,)) triples, dequantized already where the cache is
    compressed."""
    b, _, hq, hd = q.shape
    m = torch.tensor(NEG_INF, device=q.device)          # broadcast to (B,Hkv,G)
    l = torch.zeros((), device=q.device)
    acc = torch.zeros((), device=q.device)
    for kc, vc, sp in chunks:
        hkv = kc.shape[2]
        qg = q.reshape(b, hkv, hq // hkv, hd).to(torch.float32)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kc.to(torch.float32)) / math.sqrt(hd)
        s = _mask(_reduce_scores(s), sp, qpos, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgk,bkhd->bhgd", p, vc.to(torch.float32))
        acc = alpha[..., None] * acc + pv
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def decode_attention(p, x1, lc, cache_meta, cfg: ArchConfig, *, kv_mode: str,
                     num_planes: int):
    """One layer's decode attention, appending the token's K/V to the
    layer's slabs ``lc`` in place.  Returns the attention output (B,1,D)."""
    b = x1.shape[0]
    hd = cfg.resolved_head_dim
    pos, slot_pos, w = cache_meta["pos"], cache_meta["slot_pos"], cache_meta["w"]
    slot = pos % w
    q = L.dense(x1, p["wq"]).reshape(b, 1, cfg.n_heads, hd)
    k = L.dense(x1, p["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
    v = L.dense(x1, p["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x1.device)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window
    if kv_mode == "dense":
        lc["k"][:, slot] = k[:, 0]
        lc["v"][:, slot] = v[:, 0]
        if w <= DECODE_CHUNK * 2:
            out = _slab_attend(q, lc["k"], lc["v"], slot_pos, pos, window=window)
        else:
            out = _chunked_slab_attend(
                q, ((lc["k"][:, sl], lc["v"][:, sl], slot_pos[sl])
                    for sl in _chunks(w, DECODE_CHUNK)), pos, window=window)
    else:
        for nm, t in (("k", k), ("v", v)):
            mu, sexp, pl = _kv_encode(t[:, 0], num_planes)   # (B,Hkv), (B,Hkv), (P,B,Hkv,hd)
            lc[nm + "mu"][:, slot] = mu
            lc[nm + "sexp"][:, slot] = sexp
            lc[nm + "pl"][:, :, slot] = pl

        def dequant(nm, sl):
            return _kv_decode(lc[nm + "mu"][:, sl], lc[nm + "sexp"][:, sl],
                              lc[nm + "pl"][:, :, sl], x1.dtype)

        out = _chunked_slab_attend(
            q, ((dequant("k", sl), dequant("v", sl), slot_pos[sl])
                for sl in _chunks(w, min(w, DECODE_CHUNK))), pos, window=window)
    return L.dense(out.reshape(b, 1, cfg.n_heads * hd), p["wo"])


def _cross_attend(p, x1, cross_k, cross_v, cfg: ArchConfig):
    """Decoder cross-attention of x1 (B,1,D) against one layer's cached
    encoder K/V (B,T,Hkv,hd): every slot valid, no rotary embedding."""
    b = x1.shape[0]
    hd = cfg.resolved_head_dim
    q = L.dense(x1, p["wq"]).reshape(b, 1, cfg.n_heads, hd)
    t = cross_k.shape[1]
    slot_pos = torch.arange(t, dtype=torch.int32, device=x1.device)
    out = _slab_attend(q, cross_k, cross_v, slot_pos, t, window=0)
    return L.dense(out.reshape(b, 1, cfg.n_heads * hd), p["wo"])


# ---------------------------------------------------------------------------
# prefill / decode steps
# ---------------------------------------------------------------------------

@torch.no_grad()
@L.exact_matmuls()
def prefill(params, cfg: ArchConfig, tokens, *, frames=None, image_embeds=None,
            seq_len: int | None = None, kv_mode: str = "dense", num_planes: int = 1):
    """Run the full-context forward, build the cache, return (cache,
    logits of the last position (B, 1, V)).  ``frames`` (B, T, D) feed the
    encoder-decoder's encoder, ``image_embeds`` (B, P, D) the VLM's prefix;
    the cache is sized for ``seq_len`` positions (default all of them, the
    prefix included), and a shorter one is a ring that evicts."""
    h, enc_out = T._inputs(params, cfg, tokens, frames, image_embeds, T._run_layers)
    h, _, caps = T._run_layers(params["layers"], h, cfg, causal=True, enc_out=enc_out,
                               capture=True)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    logits = T.logits_for(params, cfg, h[:, -1:])
    b, s = h.shape[0], h.shape[1]
    cache = make_cache(cfg, b, seq_len or s, kv_mode=kv_mode, num_planes=num_planes,
                       dtype=h.dtype, device=h.device)
    if "k" in caps:
        fill_cache(cache, caps["k"], caps["v"], kv_mode=kv_mode, num_planes=num_planes)
    cache["pos"] = s
    if "state" in caps:
        cache["layers"]["state"].copy_(caps["state"])
        cache["layers"]["conv"].copy_(caps["conv"])
    if cfg.encoder_decoder:
        cache["cross"] = {"k": caps["cross_k"].to(h.dtype), "v": caps["cross_v"].to(h.dtype)}
    return cache, logits


@torch.no_grad()
@L.exact_matmuls()
def decode_step(params, cfg: ArchConfig, cache: dict, token, *, kv_mode: str = "dense",
                num_planes: int = 1):
    """One token (B, 1) for every sequence in the batch.  Returns (logits
    (B, 1, V), cache), the cache updated in place."""
    h = T.embed_tokens(params, cfg, token)
    pos = cache["pos"]
    slot_pos = cache["slot_pos"]
    w = slot_pos.shape[0]
    # mark the current token's slot before the layers so attention sees the
    # token it is appending (self-attention to position `pos`)
    slot_pos[pos % w] = pos
    meta = {"pos": pos, "slot_pos": slot_pos, "w": w}
    attn = T.has_attention(cfg)
    for i, lp in enumerate(params["layers"]):
        lc = {name: slab[i] for name, slab in cache["layers"].items()}
        hn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        mix = None
        if attn:
            mix = decode_attention(lp["attn"], hn, lc, meta, cfg, kv_mode=kv_mode,
                                   num_planes=num_planes)
        if "ssm" in lp:
            out, state, conv = L.mamba2_decode(lp["ssm"], hn, lc["state"], lc["conv"], cfg)
            lc["state"].copy_(state)
            lc["conv"].copy_(conv)
            mix = out if mix is None else 0.5 * (mix + out)
        h = h + mix
        if "cross" in lp:
            hn = L.rms_norm(h, lp["ln_cross"], cfg.norm_eps)
            h = h + _cross_attend(lp["cross"], hn, cache["cross"]["k"][i], cache["cross"]["v"][i],
                                  cfg)
        h, _ = T.ffn_part(lp, h, cfg)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    cache["pos"] = pos + 1
    return T.logits_for(params, cfg, h), cache
