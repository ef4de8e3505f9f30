"""``repro_torch.obs`` spans on the torch.profiler timeline, on the CPU.

While a profiler records, every span opened through ``span()``, ``traced()``
or the no-op span's decorator is also a range of the same name on the
profiler's timeline (a function-scope record, not a user annotation), with
telemetry on or off; with neither on, ``span()`` is the shared no-op and no
range is made.  Then the hot paths' spans: one ``serve.prefill`` (its
forward and cache fill inside) a prefill, one ``train.forward_backward``
and ``train.optimizer`` a step of every route, ``train.grad_exchange`` in
the compressed ones, and one ``gradcomp.encode`` and ``gradcomp.all_gather``
and two ``gradcomp.decode`` (the local decode before the all-gather, the
members' after it) a gradient leaf.
"""
from __future__ import annotations

import collections

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, obs
from repro_torch.core import pytree
from repro_torch.models import transformer as T
from repro_torch.obs.registry import Registry
from repro_torch.optim import AdamW
from repro_torch.serve import engine as E
from repro_torch.train import step as step_mod

ARCH = "llama3.2-1b"
STEP_SPANS = ("train.forward_backward", "train.grad_exchange", "train.optimizer")


@pytest.fixture(params=[False, True], ids=["obs_off", "obs_on"])
def obs_switch(request):
    obs.reset()
    (obs.enable if request.param else obs.disable)()
    yield request.param
    obs.disable()
    obs.reset()


def _ranges(prof) -> dict:
    """name -> [(start, end, is_user_annotation)] of the profile's host events."""
    out = collections.defaultdict(list)
    for e in prof.events():
        out[e.name].append((e.time_range.start, e.time_range.end, e.is_user_annotation))
    return out


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@obs.traced("decorated")
def _decorated():
    with obs.span("under"):
        return torch.ones(4).sum()


@obs.span("ignored")            # applied while off: the null span's decorator, by qualname
def _null_decorated():
    return torch.ones(2) * 2


def test_spans_reach_the_profiler(obs_switch):
    assert not obs.enabled() or obs_switch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer", step=1):
            with obs.span("inner"):
                torch.ones(3).add_(1)
            _decorated()
            _null_decorated()
    r = _ranges(prof)
    for name in ("outer", "inner", "decorated", "under", "_null_decorated"):
        assert len(r[name]) == 1, name
        assert r[name][0][2] is False, name          # not a user annotation
    assert "ignored" not in r
    outer = r["outer"][0]
    for name in ("inner", "decorated", "_null_decorated"):
        assert _inside(r[name][0], outer), name
    assert _inside(r["under"][0], r["decorated"][0])
    assert _inside(r["aten::add_"][0], r["inner"][0])
    spans = obs.REGISTRY.span_aggregates()
    if obs_switch:
        assert {"outer", "inner", "decorated", "under", "_null_decorated"} <= set(spans)
    else:
        assert not spans


def test_no_switch_no_range(monkeypatch):
    """Telemetry off and no profiler: ``span()`` is the shared no-op and no
    range object is made, by spans or decorators; a profiler turns them on."""
    obs.disable()
    made = []
    real = obs._RecordFunctionFast

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(obs, "_RecordFunctionFast", counting)
    assert obs.span("a") is obs._NULL and obs.span("b", k=1) is obs._NULL
    with obs.span("a"):
        _decorated()
        _null_decorated()
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("a"):
            _decorated()
            _null_decorated()
    assert made == ["a", "decorated", "under", "_null_decorated"]


def test_profiler_alone_touches_no_registry(monkeypatch):
    obs.disable()
    calls = []
    for name in ("_get", "record_span", "record_frame"):
        orig = getattr(Registry, name)

        def spy(self, *a, _orig=orig, _n=name, **kw):
            calls.append(_n)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(Registry, name, spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            _decorated()
            _null_decorated()
    assert calls == []
    assert {"outer", "decorated", "under", "_null_decorated"} <= set(_ranges(prof))


def test_decorators_follow_the_profiler(obs_switch):
    """A function decorated before any switch was on opens its range in the
    calls made while a profiler records, and in none after it stops."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decorated()
        _null_decorated()
    with profile(activities=[ProfilerActivity.CPU]) as after:
        pass
    _decorated()                      # between profiles: no profiler records
    r = _ranges(prof)
    assert [len(r[n]) for n in ("decorated", "under", "_null_decorated")] == [1, 1, 1]
    assert "decorated" not in _ranges(after)


# ---------------------------------------------------------------------------
# the hot paths' spans
# ---------------------------------------------------------------------------
def _cfg():
    return configs.get(ARCH).reduced()


@pytest.mark.parametrize("kv_mode", ["dense", "compressed"])
def test_prefill_spans(kv_mode):
    cfg = _cfg()
    params = T.param_tree(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    toks = torch.randint(0, cfg.vocab_size, (1, 24), generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for s in (16, 24):
            E.prefill(params, cfg, toks[:, :s], seq_len=s + 4, kv_mode=kv_mode, num_planes=1)
    r = _ranges(prof)
    assert [len(r[n]) for n in ("serve.prefill", "serve.prefill.forward",
                                "serve.prefill.kv_fill")] == [2, 2, 2]
    for outer, fwd, fill in zip(*(sorted(r[n]) for n in ("serve.prefill",
                                                         "serve.prefill.forward",
                                                         "serve.prefill.kv_fill"))):
        assert _inside(fwd, outer) and _inside(fill, outer) and fwd[1] <= fill[0]
        assert not (outer[2] or fwd[2] or fill[2])


def _batch(cfg, seed):
    t = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(seed))
    return {"tokens": t, "labels": torch.roll(t, -1, 1)}


def _check_step_spans(prof, steps: int, leaves: int, compressed: bool) -> None:
    r = _ranges(prof)
    want = {n: steps for n in STEP_SPANS}
    if not compressed:
        want["train.grad_exchange"] = 0
    assert {n: len(r[n]) for n in STEP_SPANS} == want
    for n, per_leaf in (("gradcomp.encode", 1), ("gradcomp.all_gather", 1),
                        ("gradcomp.decode", 2)):
        assert len(r[n]) == steps * leaves * per_leaf * compressed, n
    for k in range(steps):
        fb, opt = sorted(r["train.forward_backward"])[k], sorted(r["train.optimizer"])[k]
        assert fb[1] <= opt[0]
        if compressed:
            ex = sorted(r["train.grad_exchange"])[k]
            assert fb[1] <= ex[0] and ex[1] <= opt[0]
            assert all(_inside(e, ex) for e in sorted(r["gradcomp.encode"])
                       [k * leaves:(k + 1) * leaves])


@pytest.mark.parametrize("planes", [0, 1], ids=["plain", "compressed"])
def test_train_step_spans(planes, tmp_path):
    cfg = _cfg()
    opt = AdamW(lr=1e-3)
    state = step_mod.init_state(cfg, opt, torch.Generator().manual_seed(0), ef_planes=planes,
                                device="cpu")
    n_leaves = len(pytree.leaves(state["params"]))
    if planes:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
    try:
        fn = step_mod.make_train_step(cfg, opt, compress_planes=planes)
        state, _ = fn(state, _batch(cfg, 0))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for k in (1, 2):
                state, _ = fn(state, _batch(cfg, k))
    finally:
        if planes:
            dist.destroy_process_group()
    _check_step_spans(prof, 2, n_leaves, bool(planes))


@pytest.mark.parametrize("planes", [0, 1], ids=["plain", "compressed"])
def test_sharded_step_spans(planes, tmp_path):
    """The sharded step on a one-rank (pod, data, model) mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = _cfg()
    opt = AdamW(lr=1e-3)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        state = step_mod.init_sharded_state(cfg, opt, torch.Generator().manual_seed(0), mesh,
                                            ef_planes=planes, device="cpu")
        n_leaves = len(pytree.leaves(state["params"]))
        fn = step_mod.make_train_step(cfg, opt, mesh=mesh, compress_planes=planes)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for k in (0, 1):
                state, _ = fn(state, _batch(cfg, k))
    finally:
        dist.destroy_process_group()
    _check_step_spans(prof, 2, n_leaves, bool(planes))
