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

Under a mesh (inside ``models.sharding.use_rules(mesh, rules)``, the
parameters a tree of ``DTensor``s placed by ``param_specs_tree`` or
``serve_param_specs_tree``) :func:`prefill` and :func:`decode_step`
compute tensor-parallel on each rank's shards, for every family: the
batch split over ``act_batch``, the cache placed as :func:`cache_layout`
places it (K/V (L, B, W, Hkv, hd) and the cross K/V (L, B, T, Hkv, hd)
with hd over ``act_hd``'s axes, mu/sexp whole over them, the planes with
hd split; the SSM state (L, B, H, N, hp) over ``act_heads`` as the layers
split the heads, the conv tail (L, B, W-1, CC) over its channels as
``conv``'s columns are split), and the prefill's cache and logits come
back as ``DTensor``s (the logits each rank's batch rows, the whole
vocabulary).  A decode step takes the token's K/V whole over ``model``,
writes this rank's hd columns (the compressed cache encodes whole hd
blocks, so mu and sexp are the unsharded encode's, and keeps this rank's
columns of the planes), and attends with hd-partial scores all-reduced in
float32 and rounded to bf16 once (:func:`_reduce_scores`) and the output
gathered over hd; the
cross-attention reads its hd columns of the cross K/V the same way.  The
same functions serve with and without a mesh: on plain tensors outside a
rules context every split, gather and all-reduce they call is the
identity, and so is every one over a mesh dim of one member.

Long-context serving (``long_500k``'s ``LONG_CONTEXT_RULES``: the batch
whole, the sequence over ``act_seq``'s mesh dim) is served for every
family.  :func:`prefill` gives each rank its contiguous chunk of the
sequence (``sharding.member_range``; the VLM's prefix and tokens are one
sequence, of which the rank builds its range): the attention takes a halo
of the window's earlier K/V from the preceding ranks, the SSM hands its
state along the sequence, the MoE routes against the whole sequence's
capacity and the encoder-decoder's encoder runs its chunk of the frames
against all of their K/V (``models/layers.py``, ``models/transformer.py``);
each layer's capture keeps
only the positions the cache holds, which go to the ranks that own their
ring slots (``pos % W``: :func:`cache_layout` puts W over ``act_seq``'s
dim where it divides W, else every rank holds the whole window); the last
position's logits, the SSM state and the conv tail are the last rank's, the
same on every rank; the cross K/V keep the frames of the rank's chunk of
T where ``act_seq``'s members divide T.  A decode step writes the token's
K/V (or its SZx record) on the rank that owns its slot only, and each rank
attends over its slots -- ``slot_pos`` stays whole -- and over its frames
of the cross K/V, and the ranks' partial softmaxes are merged over
``act_seq`` (the max, then the rescaled sums and p @ v summed in float32):
neither the window nor the frames are gathered.

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

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.codec.device import DeviceEncoding, resolve_device
from repro_torch.core.codec.planes_codec import PlanesCodec
from repro_torch.models import layers as L, sharding as S
from repro_torch.models import transformer as T
from repro_torch.models.sharding import rules_active

NEG_INF = -1e30
DECODE_CHUNK = 2048


def _reduce_scores(s, dims=()):
    """Scores that are partial sums over head_dim split across mesh
    ``dims`` made whole, as the reference's compiled step makes them under
    a sharding-rules context: the partials all-reduced over ``dims`` in
    their own dtype, then the sum rounded to bf16 once and cast back --
    under any rules context, a one-member mesh's too.  (The reference
    writes the bf16 cast before its sharding constraint, but GSPMD places
    the all-reduce that completes the head_dim contraction on the float32
    partials, before the convert.)  Outside a rules context, ``s`` as it
    is."""
    if not rules_active():
        return s
    return S.all_reduce(s, dims).to(torch.bfloat16).to(s.dtype)


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


def fill_cache(cache: dict, k, v, *, positions, total: int, kv_mode: str = "dense",
               num_planes: int = 1, hd=slice(None), slot0: int = 0) -> dict:
    """Write a prefill's K/V (L, B, n, Hkv, hd) into a fresh cache: row i
    is absolute position ``positions[i]``, all among the last min(W,
    ``total``) positions of a prompt of ``total``, and goes to slot pos % W
    - ``slot0`` of slabs holding W's slots from ``slot0`` (a window split
    over ``act_seq``; 0 where it is whole); then pos = ``total`` and
    ``slot_pos`` the whole window's.  Compressed caches get one encode over
    all layers for K and one for V, on whole head_dim blocks.  ``hd`` is
    the slice of head_dim the slabs (the planes) hold."""
    lay = cache["layers"]
    w = cache["slot_pos"].shape[0]
    dev = cache["slot_pos"].device
    take = min(w, total)
    src_pos = torch.arange(total - take, total, device=dev)
    slot_pos = torch.full((w,), -1, dtype=torch.int32, device=dev)
    slot_pos[src_pos % w] = src_pos.to(torch.int32)
    cache["pos"] = total
    cache["slot_pos"] = slot_pos
    if positions.numel() == 0:
        return cache
    slots = positions.to(dev) % w - slot0
    if kv_mode == "dense":
        lay["k"][:, :, slots] = k[..., hd].to(lay["k"].dtype)
        lay["v"][:, :, slots] = v[..., hd].to(lay["v"].dtype)
    else:
        for nm, t in (("k", k), ("v", v)):
            mu, sexp, pl = _kv_encode(t, num_planes)         # pl: (P, L, B, n, Hkv, hd)
            lay[nm + "mu"][:, :, slots] = mu
            lay[nm + "sexp"][:, :, slots] = sexp
            lay[nm + "pl"][:, :, :, slots] = pl[..., hd].movedim(0, 1)
    return cache


# ---------------------------------------------------------------------------
# decode attention over a (possibly compressed, possibly ring) cache slab
# ---------------------------------------------------------------------------

def _mask(s, slot_pos, qpos: int, window: int):
    valid = (slot_pos >= 0) & (slot_pos <= qpos)
    if window:
        valid &= qpos - slot_pos < window
    return torch.where(valid[None, None, None, :], s, NEG_INF)


def _merge(m, l, acc, dims):
    """A softmax's partials over this rank's slots -- the max m (B,Hkv,G),
    the sum l of exp(s - m) and p @ v, acc (B,Hkv,G,hd) -- merged over mesh
    ``dims`` (a window split over ``act_seq``): m maximized, then l and acc
    rescaled by exp(m - max) and summed, in one all-reduce in their dtype
    (float32).  Returns (l, acc); as they are where ``dims`` has no
    member."""
    if not S.members(dims):
        return l, acc
    top = S.all_reduce_max(m.clone(), dims)
    alpha = torch.exp(m - top)
    both = S.all_reduce(torch.cat([acc * alpha[..., None], (l * alpha)[..., None]], dim=-1),
                        dims)
    return both[..., -1], both[..., :-1]


def _slab_attend(q, kslab, vslab, slot_pos, qpos: int, *, window: int, hd=None,
                 hd_dims=(), seq_dims=()):
    """q: (B,1,Hq,hd); slabs: (B,W,Hkv,hd); slot_pos: (W,) absolute
    positions.  Single-shot masked attention, float32 scores and p @ v
    (float64 for float64 q).  Under a mesh q and the slabs hold the
    head_dim columns of mesh ``hd_dims`` and ``hd`` is the whole head_dim
    (the scale's); the slabs hold this rank's slots of a window split over
    ``seq_dims``, whose partials :func:`_merge` joins."""
    b, _, hq, hdl = q.shape
    hkv = kslab.shape[2]
    f32 = L.acc_dtype(q.dtype)
    qg = q.reshape(b, hkv, hq // hkv, hdl).to(f32)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kslab.to(f32)) / math.sqrt(hd or hdl)
    s = _mask(_reduce_scores(s, hd_dims), slot_pos, qpos, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > NEG_INF / 2, torch.exp(s - m), 0.0)
    out = torch.einsum("bhgk,bkhd->bhgd", p, vslab.to(f32))
    l, out = _merge(m[..., 0], p.sum(-1), out, seq_dims)
    out = out / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, 1, hq, hdl).to(q.dtype)


def _chunks(w: int, chunk: int) -> list[slice]:
    """Slices of ``chunk`` slots covering W; the last may be short."""
    return [slice(i, i + chunk) for i in range(0, w, chunk)]


def _chunked_slab_attend(q, chunks, qpos: int, *, window: int, hd=None, hd_dims=(),
                         seq_dims=()):
    """Online-softmax loop over ``chunks`` of the cache: (k (B,c,Hkv,hd),
    v, slot_pos (c,)) triples, dequantized already where the cache is
    compressed; ``hd``, ``hd_dims`` and ``seq_dims`` as
    :func:`_slab_attend`'s."""
    b, _, hq, hdl = q.shape
    scale = math.sqrt(hd or hdl)
    f32 = L.acc_dtype(q.dtype)
    m = torch.tensor(NEG_INF, dtype=f32, device=q.device)   # broadcast to (B,Hkv,G)
    l = torch.zeros((), dtype=f32, device=q.device)
    acc = torch.zeros((), dtype=f32, device=q.device)
    for kc, vc, sp in chunks:
        hkv = kc.shape[2]
        qg = q.reshape(b, hkv, hq // hkv, hdl).to(f32)
        s = torch.einsum("bhgd,bkhd->bhgk", qg, kc.to(f32)) / scale
        s = _mask(_reduce_scores(s, hd_dims), sp, qpos, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgk,bkhd->bhgd", p, vc.to(f32))
        acc = alpha[..., None] * acc + pv
        m = m_new
    l, acc = _merge(m, l, acc, seq_dims)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, 1, hq, hdl).to(q.dtype)


def decode_attention(p, x1, lc, cache_meta, cfg: ArchConfig, *, kv_mode: str,
                     num_planes: int):
    """One layer's decode attention, appending the token's K/V to the
    layer's slabs ``lc`` in place.  Returns the attention output (B,1,D).
    Under a mesh (module docstring) q, k and v come whole over the model
    axis, and this rank's head_dim columns (mesh dims
    ``cache_meta["hd_dims"]``, the cache's split) are written and attended;
    the output is gathered over head_dim and ``wo`` is row-parallel.  With
    the window split over ``cache_meta["w_dims"]`` the rank holds slots
    [w0, w1): it writes the token only where its slot is among them, and
    attends over them, merged across the window's ranks."""
    b = x1.shape[0]
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    pos, slot_pos, w = cache_meta["pos"], cache_meta["slot_pos"], cache_meta["w"]
    hd_dims, w_dims = cache_meta["hd_dims"], cache_meta["w_dims"]
    w0, w1 = S.chunk_range(w, w_dims)
    slot = pos % w - w0
    mine = 0 <= slot < w1 - w0
    slot_pos, w = slot_pos[w0:w1], w1 - w0
    q = L.column_whole(x1, p["wq"], hq * hd).reshape(b, 1, hq, hd)
    k = L.column_whole(x1, p["wk"], hkv * hd).reshape(b, 1, hkv, hd)
    v = L.column_whole(x1, p["wv"], hkv * hd).reshape(b, 1, hkv, hd)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x1.device)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    h0, h1 = S.chunk_range(hd, hd_dims)
    q = q[..., h0:h1]
    window = cfg.sliding_window
    if kv_mode == "dense":
        if mine:
            lc["k"][:, slot] = k[:, 0, :, h0:h1]
            lc["v"][:, slot] = v[:, 0, :, h0:h1]
        if w <= DECODE_CHUNK * 2:
            out = _slab_attend(q, lc["k"], lc["v"], slot_pos, pos, window=window, hd=hd,
                               hd_dims=hd_dims, seq_dims=w_dims)
        else:
            out = _chunked_slab_attend(
                q, ((lc["k"][:, sl], lc["v"][:, sl], slot_pos[sl])
                    for sl in _chunks(w, DECODE_CHUNK)), pos, window=window, hd=hd,
                hd_dims=hd_dims, seq_dims=w_dims)
    else:
        for nm, t in (("k", k), ("v", v)) if mine else ():
            # whole head_dim blocks: (B,Hkv), (B,Hkv), (P,B,Hkv,hd)
            mu, sexp, pl = _kv_encode(t[:, 0], num_planes)
            lc[nm + "mu"][:, slot] = mu
            lc[nm + "sexp"][:, slot] = sexp
            lc[nm + "pl"][:, :, slot] = pl[..., h0:h1]

        def dequant(nm, sl):
            return _kv_decode(lc[nm + "mu"][:, sl], lc[nm + "sexp"][:, sl],
                              lc[nm + "pl"][:, :, sl], x1.dtype)

        out = _chunked_slab_attend(
            q, ((dequant("k", sl), dequant("v", sl), slot_pos[sl])
                for sl in _chunks(w, min(w, DECODE_CHUNK))), pos, window=window, hd=hd,
            hd_dims=hd_dims, seq_dims=w_dims)
    out = S.gather(out, -1, hd_dims, hd)
    return L.row_parallel(out.reshape(b, 1, hq * hd), p["wo"])


def _cross_attend(p, x1, cross_k, cross_v, cfg: ArchConfig, t: int, hd_dims=(), t_dims=()):
    """Decoder cross-attention of x1 (B,1,D) against one layer's cached
    encoder K/V (B,T,Hkv,hd) of ``t`` frames: every slot valid, no rotary
    embedding.  Under
    a mesh tensor-parallel over head_dim as :func:`decode_attention` is: q
    comes whole over ``wq``'s split, its head_dim columns of mesh dims
    ``hd_dims`` (the cross cache's split) score against the rank's columns
    of the K/V, the partial scores are all-reduced and rounded to bf16 (the
    reference's ``_slab_attend`` shards its ``qg`` over ``act_hd``), the output is
    gathered over head_dim and ``wo`` is row-parallel.  With the frames
    split over ``t_dims`` (``act_seq``'s) the rank scores its frames and
    the partial softmaxes are merged (:func:`_merge`)."""
    b = x1.shape[0]
    hd, hq = cfg.resolved_head_dim, cfg.n_heads
    q = L.column_whole(x1, p["wq"], hq * hd).reshape(b, 1, hq, hd)
    h0, h1 = S.chunk_range(hd, hd_dims)
    t0, t1 = S.chunk_range(t, t_dims)
    slot_pos = torch.arange(t0, t1, dtype=torch.int32, device=x1.device)
    out = _slab_attend(q[..., h0:h1], cross_k, cross_v, slot_pos, t, window=0, hd=hd,
                       hd_dims=hd_dims, seq_dims=t_dims)
    out = S.gather(out, -1, hd_dims, hd)
    return L.row_parallel(out.reshape(b, 1, hq * hd), p["wo"])


# ---------------------------------------------------------------------------
# prefill / decode steps
# ---------------------------------------------------------------------------

@obs.traced("serve.prefill")
@torch.no_grad()
@L.exact_matmuls()
def prefill(params, cfg: ArchConfig, tokens, *, frames=None, image_embeds=None,
            seq_len: int | None = None, kv_mode: str = "dense", num_planes: int = 1):
    """Run the full-context forward, build the cache, return (cache,
    logits of the last position (B, 1, V)).  ``frames`` (B, T, D) feed the
    encoder-decoder's encoder, ``image_embeds`` (B, P, D) the VLM's prefix;
    the cache is sized for ``seq_len`` positions (default all of them, the
    prefix included), and a shorter one is a ring that evicts.  Under a
    mesh (module docstring) the cache and logits are ``DTensor``s: the
    cache in :func:`cache_layout`'s layout, made from the layers' K/V and
    the cross K/V, which come whole over 'model' (the dense slabs take this
    rank's head_dim columns, the compressed cache encodes whole blocks),
    the SSM's final state of this rank's heads and its whole conv tail.
    With the sequence split over ``act_seq`` each rank runs its chunk of
    the prompt (module docstring)."""
    meshed = rules_active()
    bdims = S.mesh_dims("act_batch")
    b_all = tokens.shape[0]
    if meshed:
        if S.dividing(bdims, b_all) != bdims:
            raise ValueError(f"a batch of {b_all} does not split over the mesh dims {bdims} "
                             f"of act_batch")
    rows = [None if t is None else _batch_rows(t, bdims) for t in (tokens, frames, image_embeds)]
    s_all = rows[0].shape[1] + (rows[2].shape[1] if cfg.prefix_embeds and rows[2] is not None
                                else 0)
    whole = make_cache(cfg, b_all, seq_len or s_all, kv_mode=kv_mode, num_planes=num_planes,
                       dtype=T.compute_dtype(cfg), device="meta")
    w = whole["slot_pos"].shape[0]
    take = min(w, s_all)
    seq = S.seq_dim()
    lo, hi = 0, s_all
    if seq is not None:
        n = S.mesh_size((seq,))
        if S.member_range(s_all, seq, n - 1)[0] >= s_all:
            raise ValueError(f"a prompt of {s_all} tokens leaves the last of the {n} members of "
                             f"act_seq without a position")
        lo, hi = S.member_range(s_all, seq, S.coordinate(seq))
    with obs.span("serve.prefill.forward"):
        with S.sequence(s_all):
            h, enc_out = T._inputs(params, cfg, *rows, T._run_layers)
            h, _, caps = T._run_layers(params["layers"], h, cfg, causal=True, enc_out=enc_out,
                                       capture=True, capture_from=max(s_all - take - lo, 0))
        h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
        last = h[:, -1:].contiguous()
        if seq is not None:                          # the last position is the last rank's
            S.broadcast(last, seq, S.mesh_size((seq,)) - 1)
        logits = T.logits_for(params, cfg, last)
    with obs.span("serve.prefill.kv_fill"):
        lays = {part: {name: cache_layout(name, t.shape) for name, t in whole[part].items()}
                for part in ("layers", "cross") if part in whole}
        cache = {"pos": s_all, "slot_pos": torch.full(whole["slot_pos"].shape, -1,
                                                      dtype=torch.int32, device=h.device)}
        for part, lay in lays.items():
            cache[part] = {name: torch.zeros(_local_shape(whole[part][name].shape, lay[name]),
                                             dtype=whole[part][name].dtype, device=h.device)
                           for name in lay}
        if "k" in caps:
            kv_lay = lays["layers"]["k" if kv_mode == "dense" else "kpl"]
            h0, h1 = S.chunk_range(cfg.resolved_head_dim, kv_lay[-1])
            w_dims = kv_lay[-3]
            k, v = caps["k"], caps["v"]
            positions = torch.arange(s_all - take, s_all, device=h.device)
            if seq is not None:
                k, v, positions = _to_slot_owners(k, v, seq, max(lo, s_all - take), hi, s_all,
                                                  w, w_dims)
            fill_cache(cache, k, v, kv_mode=kv_mode, num_planes=num_planes, hd=slice(h0, h1),
                       positions=positions, total=s_all, slot0=S.chunk_range(w, w_dims)[0])
        if "state" in caps:
            cache["layers"]["state"].copy_(caps["state"])              # this rank's heads
            cache["layers"]["conv"].copy_(S.take(caps["conv"], -1, lays["layers"]["conv"][-1]))
        for nm in ("k", "v") if cfg.encoder_decoder else ():    # whole: this rank's frames, hd
            lay = lays["cross"][nm]
            cache["cross"][nm].copy_(S.take(S.take(caps["cross_" + nm], 2, lay[2]), -1,
                                            lay[-1]))
    if meshed:
        cache["slot_pos"] = S.from_local(cache["slot_pos"], ((),), whole["slot_pos"].shape)
        for part, lay in lays.items():
            cache[part] = {name: S.from_local(t, lay[name], whole[part][name].shape)
                           for name, t in cache[part].items()}
        logits = S.from_local(logits, (bdims, (), ()), (b_all,) + tuple(logits.shape[1:]))
    return cache, logits


def _to_slot_owners(k, v, seq: int, p0: int, p1: int, total: int, w: int, w_dims):
    """The sequence-sharded prefill's K/V (L, B, n, Hkv, hd) of positions
    [p0, p1) (this rank's among the last min(W, total)) sent to the ranks
    along mesh dim ``seq`` that hold their slots pos % W: the window's
    chunks over ``w_dims`` (``seq``'s where it splits W), or the whole
    window on every rank.  One all-to-all of the rows.  Returns (k, v, the
    positions of their rows), the rows this rank's slots take."""
    n = S.mesh_size((seq,))
    split_w = seq in S.members(w_dims)

    def rows_for(src: int, dst: int) -> list[int]:
        """Positions of member src's that member dst's slots take, in order."""
        a, b = S.member_range(total, seq, src)
        a = max(a, total - min(w, total))
        if not split_w:
            return list(range(a, b))
        s0, s1 = S.member_range(w, seq, dst)
        return [p for p in range(a, b) if s0 <= p % w < s1]

    me = S.coordinate(seq)
    sent = [rows_for(me, t) for t in range(n)]
    got = [rows_for(t, me) for t in range(n)]
    order = torch.tensor([p - p0 for ps in sent for p in ps], dtype=torch.long,
                         device=k.device)
    x = torch.stack([k, v]).movedim(3, 0).index_select(0, order)      # (rows, 2, L, B, Hkv, hd)
    x = S.all_to_all(x, [len(ps) for ps in sent], [len(ps) for ps in got], seq)
    x = x.movedim(0, 3)
    positions = torch.tensor([p for ps in got for p in ps], dtype=torch.long, device=k.device)
    return x[0], x[1], positions


@torch.no_grad()
@L.exact_matmuls()
def decode_step(params, cfg: ArchConfig, cache: dict, token, *, kv_mode: str = "dense",
                num_planes: int = 1):
    """One token (B, 1) for every sequence in the batch.  Returns (logits
    (B, 1, V), cache), the cache updated in place (under a mesh its local
    shards, the logits a ``DTensor``; the cache's batch split must be
    ``act_batch``'s)."""
    slabs = {name: S.placed(t) for name, t in cache["layers"].items()}
    cross = {name: S.placed(t) for name, t in cache.get("cross", {}).items()}
    bdims = S.mesh_dims("act_batch")
    hd_dims = cross_dims = w_dims = t_dims = ()
    if rules_active():
        for name, (_t, lay) in list(slabs.items()) + list(cross.items()):
            split = lay[2 if name.endswith("pl") else 1]
            if S.members(split) != S.members(bdims):
                raise ValueError(f"the cache's {name} has its batch split over mesh dims "
                                 f"{split}, the rules' act_batch over {bdims}")
        kv = slabs.get("k" if kv_mode == "dense" else "kpl")
        hd_dims, w_dims = (kv[1][-1], kv[1][-3]) if kv else ((), ())
        cross_dims, t_dims = (cross["k"][1][-1], cross["k"][1][2]) if cross else ((), ())
    h = T.embed_tokens(params, cfg, _batch_rows(token, bdims))
    pos = cache["pos"]
    slot_pos = S.to_local(cache["slot_pos"])
    w = slot_pos.shape[0]
    # mark the current token's slot before the layers so attention sees the
    # token it is appending (self-attention to position `pos`)
    slot_pos[pos % w] = pos
    meta = {"pos": pos, "slot_pos": slot_pos, "w": w, "hd_dims": hd_dims, "w_dims": w_dims}
    attn = T.has_attention(cfg)
    for i, lp in enumerate(params["layers"]):
        lc = {name: slab[i] for name, (slab, _lay) in slabs.items()}
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
            h = h + _cross_attend(lp["cross"], hn, cross["k"][0][i], cross["v"][0][i], cfg,
                                  cache["cross"]["k"].shape[2], cross_dims, t_dims)
        h, _ = T.ffn_part(lp, h, cfg)
    h = L.rms_norm(h, params["final_ln"], cfg.norm_eps)
    cache["pos"] = pos + 1
    logits = T.logits_for(params, cfg, h)
    if rules_active():
        logits = S.from_local(logits, (bdims, (), ()),
                              (token.shape[0],) + tuple(logits.shape[1:]))
    return logits, cache


# ---------------------------------------------------------------------------
# serving under a mesh (module docstring)
# ---------------------------------------------------------------------------

def cache_layout(name: str, shape) -> tuple:
    """The layout (``models/sharding.py``) the engine keeps a cache leaf
    ``name`` of whole ``shape`` in under the active rules: the batch over
    ``act_batch``'s mesh dims, head_dim over ``act_hd``'s and the window's
    W (the cross K/V's T) over ``act_seq``'s, each where it divides the dim
    -- ``launch/mesh.cache_specs_tree``'s layout under ``DEFAULT_RULES``
    and, with ``long_context=True``, under ``LONG_CONTEXT_RULES``: K/V (L,
    B, W, Hkv, hd) and the cross K/V (L, B, T, Hkv, hd), mu/sexp (L, B, W,
    Hkv) whole over head_dim's dims, the planes
    (L, P, B, W, Hkv, hd), the conv tail (L, B, W-1, CC) with CC over
    ``act_heads``'s dims where they divide it (as ``conv``'s columns).  The
    SSM state (L, B, H, N, hp) is split over ``act_heads``'s dims in the
    layers' chunks of ceil(H / n) even where n does not divide H: each rank
    holds the heads it runs, so no state moves in a step.  That is
    ``cache_specs_tree``'s layout where n divides H (mamba2-1.3b's 64 heads
    on 16), and the engine's own where it does not (hymba-1.5b's 50 heads,
    which the reference keeps whole on every rank)."""
    lay = [()] * len(shape)
    bdims = S.mesh_dims("act_batch")
    if name in ("k", "v") or name[1:] in ("mu", "sexp", "pl"):
        bi = 2 if name.endswith("pl") else 1
        lay[bi] = S.dividing(bdims, shape[bi])
        lay[bi + 1] = S.dividing(S.mesh_dims("act_seq"), shape[bi + 1])
        if name in ("k", "v") or name.endswith("pl"):
            lay[-1] = S.dividing(S.mesh_dims("act_hd"), shape[-1])
    elif name == "state":
        lay[1] = S.dividing(bdims, shape[1])
        lay[2] = S.mesh_dims("act_heads")
    elif name == "conv":
        lay[1] = S.dividing(bdims, shape[1])
        lay[3] = S.dividing(S.mesh_dims("act_heads"), shape[3])
    elif name not in ("pos", "slot_pos"):
        raise ValueError(f"no serving cache layout for {name}")
    return tuple(lay)


def _local_shape(shape, layout) -> tuple:
    """The shape of this rank's shard of a tensor of ``shape`` in ``layout``."""
    return tuple(hi - lo for lo, hi in (S.chunk_range(n, dims) for n, dims in zip(shape, layout)))


def _batch_rows(t, dims):
    """This rank's rows (over mesh ``dims``) of a (B, ...) input given whole
    or as a ``DTensor``."""
    if type(t) is not torch.Tensor and hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return S.take(t, 0, dims)
