"""The frozen reference tied to the program at a CPU size: the same
prefill logits and SZx-planes cache, and the same plain and compressed
training steps, with both computing in float32.  (This test file imports
both; the reference itself imports nothing of the program.)"""
import copy
import socket

import pytest
import torch
import torch.distributed as dist
from conftest import SEED

from perfbench import harness, traffic
from perfbench.drivers.prefill import leaf, load_weights, program_kv
from perfbench.drivers.train import optimizer
from perfbench.reference import model, planes, train, weights
from repro_torch.kernels import ref as kref
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.train import step as step_mod

BENCH = harness.load_bench()


def tiny(name: str, **over) -> tuple:
    conf = harness.config_file(
        {"configs": [{"name": name, "file": f"perfbench/tests/data/tiny-{name}.json"}]}, name)
    conf = dict(conf, compute_dtype="float32", **over)
    return conf, model.Arch.from_config(conf)


def test_grad_block_is_the_programs():
    from repro_torch.core import grad_compress

    assert planes.GRAD_BLOCK == grad_compress.DEFAULT_BLOCK


@pytest.mark.parametrize("num_planes", [1, 2])
@pytest.mark.parametrize("bs", [4, 80, 128])
def test_planes_codec_matches_the_programs_plain_version(num_planes, bs):
    g = torch.Generator().manual_seed(num_planes * 1000 + bs)
    x = torch.randn(64, bs, generator=g) * torch.logspace(-3, 3, 64)[:, None]
    x[3] = 0.25                                   # a constant block
    mu, sexp, pl = planes.encode(x, num_planes)
    mu2, sexp2, pl2 = kref.planes_encode_ref(x, num_planes)
    radius = (x.amax(-1) - x.amin(-1)) / 2
    moving = radius > 0                # a constant block's exponent is a convention
    assert torch.equal(mu, mu2) and torch.equal(sexp[moving], sexp2[moving])
    # the same integers but for a rounding tie now and then: the program
    # rounds its powers of two as its own reference's exp2 does, a few ulp
    # off the exact ones taken here
    assert float((pl != pl2).float().mean()) < 0.01
    dec, dec2 = planes.decode(mu, sexp, pl), kref.planes_decode_ref(mu2, sexp2, pl2)
    step = radius[:, None] * 2.0 ** (2 - 8 * num_planes)
    assert bool(((dec - dec2).abs() <= step).all())
    assert bool(((dec - x).abs() <= step / 2 + 1e-30).all())


@pytest.mark.parametrize("name", ["yi", "danube"])
def test_prefill_logits_and_cache(name):
    conf, arch = tiny(name)
    mix = harness.mix_file("rag-prefill-4k.szx-kv1")
    cfg = harness.arch_config(name, conf, mix)
    prog = T.Transformer(cfg, device="cpu")
    params = T.param_tree(prog)
    load_weights(params, arch, SEED, "cpu")
    w = weights.make_all(arch, SEED, "cpu")
    tokens = torch.randint(0, arch.vocab, (1, 61), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    cache, logits = E.prefill(params, cfg, tokens, seq_len=61 + 7, kv_mode="compressed",
                              num_planes=1)
    kv = program_kv(cache, 61)
    refs = []
    ref = model.prefill(w, arch, tokens[0], on_layer=lambda i, k, v: refs.append((k, v)))
    assert torch.allclose(logits[0, -1], ref, atol=2e-5, rtol=2e-5)
    for i, (k, v) in enumerate(refs):
        pos, *held = kv(i)
        assert pos.tolist() == list(range(max(0, 61 - (arch.window or 61)), 61))
        for got, want in zip(held, (k[pos], v[pos])):
            # the cache holds the encoding of the program's K/V: within the
            # planes' error of the reference's own encoding
            mine = planes.decode(*planes.encode(want, 1))
            step = (want.amax(-1) - want.amin(-1))[..., None] * 2.0 ** -7
            assert bool(((got - mine).abs() <= step + 1e-5).all())


def one_member_group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)


@pytest.mark.parametrize("planes_n", [0, 1])
def test_training_steps(planes_n):
    conf, arch = tiny("danube", sliding_window=8)
    mix = copy.deepcopy(harness.mix_file("pretrain-2k.szx-grad1" if planes_n
                                         else "pretrain-2k.plain"))
    mix.update(batch=2, seq=16, remat=True)
    cfg = harness.arch_config("danube", conf, mix)
    opt = optimizer(mix)
    batches = traffic.train_batches(mix, arch.vocab, SEED, "cpu", 2)
    if planes_n:
        one_member_group()
    try:
        state = step_mod.init_state(cfg, opt, torch.Generator().manual_seed(0),
                                    ef_planes=planes_n, device="cpu")
        load_weights(state["params"], arch, SEED, "cpu")
        fn = step_mod.make_train_step(cfg, opt, compress_planes=planes_n)
        losses = []
        for t, lab in batches:
            state, met = fn(state, {"tokens": t, "labels": lab})
            losses.append(float(met["loss"]))
    finally:
        if planes_n:
            dist.destroy_process_group()
    ref = train.follow(arch, SEED, batches, mix, "cpu")
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    got = train.delta_norms(arch, SEED, {n: leaf(state["params"], n)
                                         for n, _, _ in weights.all_leaf_specs(arch)}, "cpu")
    for n, d in ref["delta"].items():
        assert got[n] == pytest.approx(d, rel=2e-3), n
