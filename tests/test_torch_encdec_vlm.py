"""The audio encoder-decoder and VLM families of the port against the JAX
package, on the CPU.

``repro_torch`` (``models.layers.attention(kv_override=)``/``cross_kv``,
``models.transformer`` with ``encode``, ``frontend_proj`` and the cross
blocks, ``serve.engine`` with the cross cache and the VLM prefix, the serve
and train launchers) against ``repro`` on the reduced whisper-medium (2
encoder and 2 decoder layers, d_model 64, 4 heads of 16, 24 frames) and
internvl2-1b (2 layers, 4 query heads over 1 kv head, an 8-embedding image
prefix, tied embeddings), float32, with the reference's weights loaded
through ``params_from_jax`` and inputs made with numpy from a seed.

Tolerances (float32; torch's CPU kernels and XLA's sum in other orders), as
tests/test_torch_families.py states them, each with what it measured here:
  * a layer (``cross_kv``, the cross-attention): 1e-5 relative, 1e-6
    absolute (measured up to 6.0e-7 absolute);
  * the encoder's output and the hidden states through the model: 1e-4
    relative, 1e-5 absolute (measured up to 2.9e-6 absolute);
  * logits: within ``LOGIT_TOL`` = 1e-4 of the largest one (measured up to
    9.9e-7 for the prefill, 7.6e-7 for the same-cache decode steps and
    1.0e-6 for the free-running ones held); the decode steps run both
    engines from the same cache, the reference's after the previous step
    given to the port, and the port's free-running logits are held where
    its quantized records equal the reference's, those records at most one
    quantum apart where they do not (tests/test_torch_serve.py says why);
  * the cross cache of the prefill: ``MODEL`` (both are the encoder's
    output through ``cross_kv``; measured up to 1.4e-6 absolute);
  * the compressed prefill cache: bit for bit, fed the reference's own K/V
    (its layer scan's captures);
  * decode after prefill against forward over the same tokens (the
    reference's criterion, tests/test_models.py): 1e-3 dense and 0.06
    compressed of the largest logit (measured up to 6.5e-7 dense, 1.3e-2
    at P = 1, 7.3e-5 at P = 2);
  * the loss: 1e-5 relative; every gradient 1e-4 of the leaf's largest
    (tests/test_torch_train.py's tolerances; measured up to 1.5e-7 and
    2.1e-6); the flash backward at the cross-attention's shapes: 1e-5 of
    the largest gradient (measured up to 6.1e-7).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve import engine as RE
from repro_torch import configs
from repro_torch.core import pytree
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.train import step as step_mod

WHISPER, VLM = "whisper-medium", "internvl2-1b"
ARCHS = [WHISPER, VLM]
B, S, EXTRA = 2, 16, 4             # prompts, prompt length, decode steps
MODES = [("dense", 1), ("compressed", 1), ("compressed", 2)]
RUNS = [(a, m, p) for a in ARCHS for m, p in MODES]
LOGIT_TOL = 1e-4
LAYER = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    rcfg, cfg = rconfigs.get(arch).reduced(), configs.get(arch).reduced()
    rp = RT.init_params(rcfg, jax.random.key(0))
    tree = jax.tree.map(np.asarray, rp)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(np.int32)
    extra = {}
    if cfg.encoder_decoder:
        extra["frames"] = rng.standard_normal((B, cfg.encoder_len, cfg.d_model), dtype=np.float32)
    if cfg.prefix_embeds:
        extra["image_embeds"] = rng.standard_normal((B, cfg.prefix_embeds, cfg.d_model),
                                                    dtype=np.float32)
    return rcfg, cfg, rp, tree, T.params_from_jax(tree, cfg, "cpu"), toks, extra


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(extra):
    return {k: jnp.asarray(v) for k, v in extra.items()}


def _p(extra):
    return {k: _t(v) for k, v in extra.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


def _unstack(tree):
    """The reference's tree (layers stacked on a leading axis, in ``layers``
    and ``encoder.layers``) as the port's ``param_tree`` (lists), numpy."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            n = jax.tree.leaves(v)[0].shape[0]
            out[k] = [jax.tree.map(lambda a, i=i: np.asarray(a[i]), v) for i in range(n)]
        elif isinstance(v, dict):
            out[k] = _unstack(v)
        else:
            out[k] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_every_weight(arch):
    """Every leaf of the reference's tree, the encoder, the cross blocks and
    frontend_proj included, lands in the module and in ``param_tree`` under
    the reference's names (the checkpoint's and AdamW's view)."""
    _rcfg, cfg, _rp, tree, m, _toks, _extra = _setup(arch)
    assert sum(p.numel() for p in m.parameters()) == sum(x.size for x in jax.tree.leaves(tree))
    want = dict(pytree.leaf_paths(_unstack(tree)))
    got = dict(pytree.leaf_paths(T.param_tree(m)))
    assert list(got) == list(want)
    assert "frontend_proj" in want
    if cfg.encoder_decoder:
        assert {"encoder/final_ln", "layers/1/cross/wv", "layers/0/ln_cross",
                "encoder/layers/1/attn/wq"} <= set(want)
        assert not any("cross" in n for n in want if n.startswith("encoder/"))
    for name, w in got.items():
        assert np.array_equal(w.numpy(), want[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_reference_shapes(arch):
    """The reference's init shapes and the fan-in rule: frontend_proj and
    the cross projections normal * d_model^-0.5, the norms ones."""
    rcfg, cfg = (dataclasses.replace(c, d_model=128) for c in (rconfigs.get(arch).reduced(),
                                                                configs.get(arch).reduced()))
    m = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = _unstack(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), RT.param_specs(rcfg)))
    got = dict(pytree.leaf_paths(T.param_tree(m)))
    want = dict(pytree.leaf_paths(specs))
    assert {n: tuple(t.shape) for n, t in got.items()} == {n: w.shape for n, w in want.items()}
    fp = got["frontend_proj"]
    assert abs(float(fp.std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    if cfg.encoder_decoder:
        assert abs(float(got["layers/0/cross/wk"].std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
        assert torch.equal(got["encoder/final_ln"], torch.ones(128))
        assert torch.equal(got["layers/1/ln_cross"], torch.ones(128))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("positions", [False, True], ids=["no_rope", "rope_on_q"])
def test_cross_kv_and_attention_with_kv_override(positions):
    """cross_kv projects the encoder output; attention with kv_override
    attends to it, non-causal, Sq 16 against Skv 24, with RoPE on q only
    where positions are given."""
    rcfg, cfg, rp, _tree, m, _toks, _extra = _setup(WHISPER)
    rcross = jax.tree.map(lambda a: a[1], rp["layers"]["cross"])
    cross = m["layers"][1]["cross"]
    x, enc = _x((B, S, cfg.d_model), 3), _x((B, cfg.encoder_len, cfg.d_model), 4)
    kw = {"positions": np.arange(5, 5 + S)} if positions else {}
    rkv = RL.cross_kv(rcross, jnp.asarray(enc), rcfg)
    kv = L.cross_kv(cross, _t(enc), cfg)
    for a, b in zip(kv, rkv):
        assert tuple(a.shape) == b.shape == (B, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
        _close(a, b, LAYER)
    want, _ = RL.attention(rcross, jnp.asarray(x), rcfg, causal=False, kv_override=rkv,
                                   **{k: jnp.asarray(v) for k, v in kw.items()})
    got, (k, _v) = L.attention(cross, _t(x), cfg, causal=False, kv_override=kv,
                               **{k: _t(v) for k, v in kw.items()})
    assert k is kv[0]
    _close(got, want, LAYER)


@pytest.mark.parametrize("zero", [False, True], ids=["frames", "zero_frames"])
def test_encode_matches_reference(zero):
    """The encoder over stub frames; over zero frames (the serve launcher's)
    the final norm's rsqrt(0 + eps) keeps it finite, as in the reference."""
    rcfg, cfg, rp, _tree, m, _toks, extra = _setup(WHISPER)
    frames = np.zeros_like(extra["frames"]) if zero else extra["frames"]
    want = RT.encode(rp, rcfg, jnp.asarray(frames))
    got = T.encode(m, cfg, _t(frames))
    assert tuple(got.shape) == (B, cfg.encoder_len, cfg.d_model)
    assert bool(torch.isfinite(got).all())
    _close(got, want, MODEL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,skv", [(16, 24), (40, 24)])
def test_flash_gradients_at_cross_shapes(sq, skv, causal):
    """The flash backward with Sq != Skv (the cross-attention's shapes, and
    a causal rectangle) against jax.grad of the reference's attention."""
    rng = np.random.default_rng(sq + skv)
    q, do = (rng.standard_normal((2, sq, 4, 16), dtype=np.float32) for _ in range(2))
    k, v = (rng.standard_normal((2, skv, 4, 16), dtype=np.float32) for _ in range(2))

    def f(q, k, v):
        return jnp.sum(RL.flash_attention(q, k, v, causal=causal, q_chunk=16, kv_chunk=16) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    fa.FlashAttention.apply(tq, tk, tv, causal, 0).backward(_t(do))
    for name, a, c in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        c = np.asarray(c)
        np.testing.assert_allclose(a.numpy(), c, rtol=0, atol=1e-5 * np.abs(c).max(),
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits(arch):
    """forward with frames (whisper) or image embeddings (internvl2-1b, the
    hidden states of the prefix and the tokens) and the logits."""
    rcfg, cfg, rp, _tree, m, toks, extra = _setup(arch)
    hj, _ = RT.forward(rp, rcfg, jnp.asarray(toks), **_j(extra))
    h, _ = T.forward(m, cfg, _t(toks), **_p(extra))
    assert tuple(h.shape) == (B, S + EXTRA + cfg.prefix_embeds, cfg.d_model)
    _close(h, hj, MODEL)
    lj = np.asarray(RT.logits_for(rp, rcfg, hj))
    assert _rel(T.logits_for(m, cfg, h).numpy(), lj) <= LOGIT_TOL


def _np_cache(cache):
    out = {"pos": int(cache["pos"]), "slot_pos": np.array(cache["slot_pos"]),
           "layers": {k: np.array(v) for k, v in cache["layers"].items()}}
    if "cross" in cache:
        out["cross"] = {k: np.array(v) for k, v in cache["cross"].items()}
    return out


def _port_cache(cache):
    """A cache of ``_np_cache``'s form as the port's engine takes it."""
    out = {"pos": cache["pos"], "slot_pos": _t(cache["slot_pos"]),
           "layers": {k: _t(v) for k, v in cache["layers"].items()}}
    if "cross" in cache:
        out["cross"] = {k: _t(v) for k, v in cache["cross"].items()}
    return out


def _seq(cfg):
    return S + EXTRA + cfg.prefix_embeds


@functools.lru_cache(maxsize=None)
def _reference_run(arch, mode, planes):
    rcfg, cfg, rp, _tree, _m, toks, extra = _setup(arch)
    cache, logits = RE.prefill(rp, rcfg, jnp.asarray(toks[:, :S]), seq_len=_seq(cfg),
                               kv_mode=mode, num_planes=planes, **_j(extra))
    out = [(np.asarray(logits), _np_cache(cache))]
    for i in range(EXTRA):
        logits, cache = RE.decode_step(rp, rcfg, cache, jnp.asarray(toks[:, S + i:S + i + 1]),
                                       kv_mode=mode, num_planes=planes)
        out.append((np.asarray(logits), _np_cache(cache)))
    return out


@functools.lru_cache(maxsize=None)
def _port_run(arch, mode, planes):
    _rcfg, cfg, _rp, _tree, m, toks, extra = _setup(arch)
    cache, logits = E.prefill(m, cfg, _t(toks[:, :S]), seq_len=_seq(cfg), kv_mode=mode,
                              num_planes=planes, **_p(extra))
    out = [(logits.numpy(), _np_cache(cache))]
    for i in range(EXTRA):
        logits, cache = E.decode_step(m, cfg, cache, _t(toks[:, S + i:S + i + 1]), kv_mode=mode,
                                      num_planes=planes)
        out.append((logits.numpy(), _np_cache(cache)))
    return out


def _signed_q(planes):
    """The quantized integers of uint8 planes (P, ...)."""
    p = planes.shape[0]
    uq = sum(planes[k].astype(np.int64) << (8 * k) for k in range(p))
    return np.where(uq >= 1 << (8 * p - 1), uq - (1 << (8 * p)), uq)


def _quantized_records_differ(got, want) -> bool:
    """Whether two compressed caches' quantized records (sexp, planes)
    differ; asserts the same sexp, quantized values at most one step apart
    and mu close."""
    differ = False
    for nm in "kv":
        assert np.array_equal(got[nm + "sexp"], want[nm + "sexp"]), nm
        dq = (_signed_q(np.moveaxis(got[nm + "pl"], 1, 0))
              - _signed_q(np.moveaxis(want[nm + "pl"], 1, 0)))
        assert np.abs(dq).max() <= 1, nm
        np.testing.assert_allclose(got[nm + "mu"], want[nm + "mu"], rtol=1e-4, atol=1e-5)
        differ |= bool(dq.any())
    return differ


@pytest.mark.parametrize("arch,mode,planes", RUNS)
def test_logits_match_reference(arch, mode, planes):
    """The prefill's logits and its cross cache; each decode step's logits
    from the same cache; the free-running logits where the port's records
    are the reference's; pos, slot_pos, slab shapes after each call."""
    _rcfg, cfg, _rp, _tree, m, toks, _extra = _setup(arch)
    ref_out, port_out = _reference_run(arch, mode, planes), _port_run(arch, mode, planes)
    for step, ((lr, cr), (lp, cp)) in enumerate(zip(ref_out, port_out)):
        assert lp.shape == lr.shape and lp.dtype == np.float32
        assert cp["pos"] == cr["pos"] and np.array_equal(cp["slot_pos"], cr["slot_pos"])
        assert {k: (v.shape, v.dtype) for k, v in cp["layers"].items()} == \
            {k: (v.shape, v.dtype) for k, v in cr["layers"].items()}
        assert cp.keys() == cr.keys()
        if "cross" in cr:
            for nm in "kv":
                assert cp["cross"][nm].shape == cr["cross"][nm].shape == \
                    (cfg.n_layers, B, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
                _close(cp["cross"][nm], cr["cross"][nm], MODEL)
        if step:
            same, _ = E.decode_step(m, cfg, _port_cache(ref_out[step - 1][1]),
                                    _t(toks[:, S + step - 1:S + step]), kv_mode=mode,
                                    num_planes=planes)
            assert _rel(same.numpy(), lr) <= LOGIT_TOL, (arch, mode, step, "same cache")
        differ = mode == "compressed" and _quantized_records_differ(cp["layers"], cr["layers"])
        if step == 0 or not differ:
            assert _rel(lp, lr) <= LOGIT_TOL, (arch, mode, step, "free-running")


@pytest.mark.parametrize("arch,mode,planes", RUNS)
def test_prefill_cache_bit_identical_on_the_same_kv(arch, mode, planes):
    """Fed the reference's own K/V (its layer scan's captures, the prefix's
    positions included for the VLM), the port writes the reference's
    records -- K/V, mu, sexp, planes, slot_pos, pos -- bit for bit."""
    rcfg, cfg, rp, _tree, _m, toks, extra = _setup(arch)
    h = RT.embed_tokens(rp, rcfg, jnp.asarray(toks[:, :S]))
    enc = None
    if cfg.prefix_embeds:
        pre = RL.dense(jnp.asarray(extra["image_embeds"]), rp["frontend_proj"])
        h = jnp.concatenate([pre, h], axis=1)
    if cfg.encoder_decoder:
        enc = RT.encode(rp, rcfg, jnp.asarray(extra["frames"]))
    _h, _aux, caps = RT._run_layers(rp["layers"], h, rcfg, causal=True, enc_out=enc,
                                    capture=True)
    cache = E.make_cache(cfg, B, _seq(cfg), kv_mode=mode, num_planes=planes,
                         dtype=torch.float32, device="cpu")
    s = caps["k"].shape[2]
    take = min(cache["slot_pos"].shape[0], s)
    E.fill_cache(cache, _t(caps["k"][:, :, s - take:]), _t(caps["v"][:, :, s - take:]),
                 positions=torch.arange(s - take, s), total=s, kv_mode=mode, num_planes=planes)
    want = _reference_run(arch, mode, planes)[0][1]
    got = _np_cache(cache)
    assert got["pos"] == want["pos"] == S + cfg.prefix_embeds
    assert np.array_equal(got["slot_pos"], want["slot_pos"])
    for name, arr in want["layers"].items():
        assert got["layers"][name].dtype == arr.dtype, name
        assert np.array_equal(got["layers"][name].view(np.uint8), arr.view(np.uint8)), name


@pytest.mark.parametrize("arch,mode,planes", RUNS)
def test_prefill_decode_matches_forward(arch, mode, planes):
    """tests/test_models.py's teacher-forcing criterion: decode after
    prefill equals forward over the same tokens (the frames or the prefix
    alike) within 1e-3 (dense) and 0.06 (compressed) of the largest
    logit."""
    _rcfg, cfg, _rp, _tree, m, toks, extra = _setup(arch)
    h, _ = T.forward(m, cfg, _t(toks), **_p(extra))
    full = T.logits_for(m, cfg, h[:, -1:]).numpy()
    assert _rel(_port_run(arch, mode, planes)[-1][0], full) < (1e-3 if mode == "dense" else 0.06)


def test_vlm_cache_without_the_prefix_is_a_ring_as_in_the_reference():
    """A caller whose seq_len leaves the prefix out gets a cache of seq_len
    slots that evicts, in both packages (repro/serve/engine.py:347-352)."""
    rcfg, cfg, rp, _tree, m, toks, extra = _setup(VLM)
    rcache, rl = RE.prefill(rp, rcfg, jnp.asarray(toks[:, :S]), seq_len=S + EXTRA, **_j(extra))
    cache, lg = E.prefill(m, cfg, _t(toks[:, :S]), seq_len=S + EXTRA, **_p(extra))
    assert cache["slot_pos"].shape == (S + EXTRA,) and cache["pos"] == S + cfg.prefix_embeds
    assert np.array_equal(cache["slot_pos"].numpy(), np.asarray(rcache["slot_pos"]))
    assert _rel(lg.numpy(), np.asarray(rl)) <= LOGIT_TOL
    rl, _ = RE.decode_step(rp, rcfg, rcache, jnp.asarray(toks[:, S:S + 1]))
    lg, _ = E.decode_step(m, cfg, cache, _t(toks[:, S:S + 1]))
    assert _rel(lg.numpy(), np.asarray(rl)) <= LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,planes", [("dense", 1), ("compressed", 2)])
def test_cache_bytes_are_the_slab_shapes(arch, mode, planes):
    """The slabs of the reference's make_cache, the cross K/V included, and
    cache_nbytes counting them."""
    rcfg, cfg = rconfigs.get(arch).reduced(), configs.get(arch).reduced()
    b, seq = 3, 40
    cache = E.make_cache(cfg, b, seq, kv_mode=mode, num_planes=planes, dtype=torch.float32,
                         device="cpu")
    spec = jax.eval_shape(lambda: RE.make_cache(rcfg, b, seq, kv_mode=mode, num_planes=planes,
                                                dtype=jnp.float32))

    def shapes(part):
        return {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in part.items()}

    assert shapes(cache["layers"]) == shapes(spec["layers"])
    assert ("cross" in cache) == ("cross" in spec) == cfg.encoder_decoder
    per = cfg.head_dim * 4 if mode == "dense" else 4 + 1 + planes * cfg.head_dim
    want = cfg.n_layers * 2 * b * seq * cfg.n_kv_heads * per
    if cfg.encoder_decoder:
        assert shapes(cache["cross"]) == shapes(spec["cross"])
        want += cfg.n_layers * 2 * b * cfg.encoder_len * cfg.n_kv_heads * cfg.head_dim * 4
    assert E.cache_nbytes(cache) == want


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch, remat):
    """loss_fn over a SyntheticLM batch with its frames or image embeddings
    (the VLM's prefix takes no loss) and every gradient, the encoder's and
    frontend_proj's included, against jax.value_and_grad."""
    rcfg, cfg, rp, _tree, _m, _toks, _extra = _setup(arch)
    rcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (rcfg, cfg))
    batch = SyntheticLM(train_cli.data_config(cfg, 24, 2)).batch_at(0)
    assert ("frames" in batch) == cfg.encoder_decoder
    assert ("image_embeds" in batch) == bool(cfg.prefix_embeds)
    rloss, rgrads = jax.value_and_grad(RT.loss_fn)(rp, rcfg, _j(batch))
    params = T.param_tree(T.params_from_jax(jax.tree.map(np.asarray, rp), cfg, "cpu"))
    loss, grads = step_mod.value_and_grad(cfg, params, _p(batch))
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = dict(pytree.leaf_paths(_unstack(rgrads)))
    got = dict(pytree.leaf_paths(grads))
    assert list(got) == list(want)
    for name, a in got.items():
        b = want[name]
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["dense", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_the_cpu(capsys, arch, mode):
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt", "12", "--tokens", "5", "--kv-mode", mode])
    out = capsys.readouterr().out
    assert f"{arch} kv={mode} on cpu:" in out and "tok/s" in out and "sample row" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_cpu(tmp_path, capsys, arch):
    """Two steps through the launcher: its synthetic batches carry the stub
    frames or image embeddings, the losses are finite and the weights
    move."""
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--seq", "16", "--batch", "2",
            "--device", "cpu"]
    tr, state = train_cli.run(train_cli.build_parser().parse_args(
        argv + ["--ckpt", str(tmp_path / "run")]), torch.device("cpu"))
    assert len(tr.history) == 2 and all(np.isfinite(h["loss"]) for h in tr.history)
    cfg = configs.get(arch).reduced()
    init = dict(pytree.leaf_paths(T.param_tree(
        T.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu"))))
    moved = {n: float((a - init[n]).abs().max()) for n, a in pytree.leaf_paths(state["params"])}
    assert moved["frontend_proj"] > 0 and moved["layers/0/attn/wq"] > 0
    if cfg.encoder_decoder:
        assert moved["encoder/layers/0/attn/wq"] > 0 and moved["layers/1/cross/wk"] > 0
    again = train_cli.main(argv + ["--ckpt", str(tmp_path / "main")])
    assert f"arch={arch} on cpu" in capsys.readouterr().out
    assert [h["loss"] for h in again.history] == [h["loss"] for h in tr.history]
