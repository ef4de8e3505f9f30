"""repro_torch's partition specs against the JAX package's.

For every architecture and both production meshes -- (16, 16) over
('data', 'model') and (2, 16, 16) over ('pod', 'data', 'model') -- the
port's ``launch/mesh.py`` spec trees must equal ``repro/launch/mesh.py``'s:
parameters (training and serving layouts), replicated, batch (with and
without long context), decode caches (dense and compressed KV, SSM state
and conv, the cross cache) and ``train.step.state_specs``.  The reference
stacks its layers on a leading axis, so a layer leaf's reference spec
carries a leading ``None`` (after ``pod`` for the error feedback) that the
port's per-layer leaves drop.  Neither package builds a mesh here: the
reference's specs read ``axis_names`` and ``devices.shape`` and the port's
``mesh_dim_names`` and ``shape``, so stand-ins with those attributes give
the production specs without 256 devices (``jax.make_mesh`` would refuse
on one host device).  The per-device bytes of the parameters, the train
state and the caches under those specs must be the reference's exactly.
"""
import dataclasses
import functools
import re
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs.base import input_specs as rinput_specs
from repro.core.codec.tree import leaf_name as rleaf_name
from repro.launch import mesh as rmesh
from repro.models import transformer as RT
from repro.optim import AdamW as RAdamW
from repro.roofline import analysis as ranalysis
from repro.serve import engine as rengine
from repro.train import step as rstep
from repro_torch import configs
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.core import pytree
from repro_torch.launch import mesh as M
from repro_torch.models import sharding
from repro_torch.models import transformer as T
from repro_torch.roofline import analysis
from repro_torch.serve import engine
from repro_torch.train import step as S

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = configs.ARCH_NAMES
CASES = [(a, m) for a in ARCHS for m in MESHES]
CACHE_MODES = [("dense", 1), ("compressed", 2)]


def _meshes(name):
    shape, axes = MESHES[name]
    return (types.SimpleNamespace(axis_names=axes, devices=np.empty(shape)),
            types.SimpleNamespace(mesh_dim_names=axes, shape=shape))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return RT.param_specs(rconfigs.get(arch))


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    return jax.eval_shape(functools.partial(rstep.init_state, rconfigs.get(arch),
                                            RAdamW(lr=1e-3), jax.random.key(0), ef_planes=1))


def _ref_named(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {rleaf_name(kp): tuple(leaf) for kp, leaf in flat}


def _same_specs(port_tree, ref_tree) -> None:
    """Every port spec equals the reference's at the same name, the stacked
    lead dropped for a per-layer leaf; both trees have the same leaves."""
    ref = _ref_named(ref_tree)
    seen = set()
    port = pytree.leaf_paths(port_tree)
    assert port and all(isinstance(s, M.P) for _, s in port)
    for name, spec in port:
        stacked = re.sub(r"(^|/)layers/\d+/", r"\1layers/", name)
        want = ref[stacked]
        if stacked != name:                 # a layer leaf: drop the stacked lead
            lead = 1 if name.startswith("ef/") else 0
            assert want[lead] is None, (name, want)
            want = want[:lead] + want[lead + 1:]
        assert tuple(spec) == want, (name, tuple(spec), want)
        seen.add(stacked)
    assert seen == set(ref), sorted(set(ref) ^ seen)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_specs_match_reference(arch, mesh):
    rm, pm = _meshes(mesh)
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    _same_specs(M.param_specs_tree(cfg, T.param_specs(cfg), pm),
                rmesh.param_specs_tree(rcfg, _ref_params(arch), rm))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_serve_param_specs_match_reference(arch, mesh):
    rm, pm = _meshes(mesh)
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    _same_specs(M.serve_param_specs_tree(cfg, T.param_specs(cfg), pm),
                rmesh.serve_param_specs_tree(rcfg, _ref_params(arch), rm))


@pytest.mark.parametrize("arch", ARCHS)
def test_replicated_specs_match_reference(arch):
    _same_specs(M.replicated_specs_tree(T.param_specs(configs.get(arch))),
                rmesh.replicated_specs_tree(_ref_params(arch)))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_batch_specs_match_reference(arch, mesh):
    rm, pm = _meshes(mesh)
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    for shape in SHAPES:
        for long_context in (False, True):
            port = M.batch_specs_tree(cfg, pm, input_specs(cfg, shape), long_context=long_context)
            ref = rmesh.batch_specs_tree(rcfg, rm, rinput_specs(rcfg, shape),
                                         long_context=long_context)
            _same_specs(port, ref)
            got = analysis.sharded_bytes_per_device(input_specs(cfg, shape), port, pm)
            assert got == ranalysis.sharded_bytes_per_device(rinput_specs(rcfg, shape), ref, rm)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_specs_match_reference(arch, mesh):
    """Dense and compressed KV, the SSM state and conv, the cross cache, at
    decode_32k and (long context) long_500k's shapes; bytes a device too."""
    rm, pm = _meshes(mesh)
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    for shape, long_context in (("decode_32k", False), ("long_500k", True)):
        b, s = SHAPES[shape]["global_batch"], SHAPES[shape]["seq_len"]
        for kv_mode, P in CACHE_MODES:
            cache = engine.cache_specs(cfg, b, s, kv_mode=kv_mode, num_planes=P)
            rcache = rengine.cache_specs(rcfg, b, s, kv_mode=kv_mode, num_planes=P)
            port = M.cache_specs_tree(cfg, pm, cache, long_context=long_context)
            ref = rmesh.cache_specs_tree(rcfg, rm, rcache, long_context=long_context)
            _same_specs(port, ref)
            assert all(t.device.type == "meta" for t in pytree.leaves(cache))
            assert (analysis.sharded_bytes_per_device(cache, port, pm)
                    == ranalysis.sharded_bytes_per_device(rcache, ref, rm))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_state_specs_and_bytes_match_reference(arch, mesh):
    rm, pm = _meshes(mesh)
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    template = S.state_template(cfg, ef_planes=1)
    port = S.state_specs(cfg, template, pm)
    ref = rstep.state_specs(rcfg, _ref_state(arch), rm)
    _same_specs(port, ref)
    assert (analysis.sharded_bytes_per_device(template, port, pm)
            == ranalysis.sharded_bytes_per_device(_ref_state(arch), ref, rm))
    pspecs = M.param_specs_tree(cfg, T.param_specs(cfg), pm)
    assert (analysis.sharded_bytes_per_device(T.param_specs(cfg), pspecs, pm)
            == ranalysis.sharded_bytes_per_device(
                _ref_params(arch), rmesh.param_specs_tree(rcfg, _ref_params(arch), rm), rm))


def test_deepseek_bytes_a_device():
    """deepseek-moe-16b's float32 parameters: 0.264 GB a device on (16, 16)
    and 16.88 GB on (4, 1) (FSDP over 'data'); its weights and AdamW
    moments 50.6 GB on (4, 1), 67.5 GB with the gradients."""
    cfg = configs.get("deepseek-moe-16b")
    params = T.param_specs(cfg)
    for shape, want in (((16, 16), 0.264), ((4, 1), 16.88)):
        pm = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
        got = analysis.sharded_bytes_per_device(params, M.param_specs_tree(cfg, params, pm), pm)
        assert round(got / 1e9, 3 if want < 1 else 2) == want
    pm = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(4, 1))
    template = S.state_template(cfg)
    state = analysis.sharded_bytes_per_device(template, S.state_specs(cfg, template, pm), pm)
    assert round(state / 1e9, 1) == 50.6 and round(state * 4 / 3 / 1e9, 1) == 67.5


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    cfg, rcfg = configs.get(arch), rconfigs.get(arch)
    for tokens in (1, 4096 * 256):
        assert analysis.train_model_flops(cfg, tokens) == ranalysis.train_model_flops(rcfg, tokens)
    for batch in (1, 128):
        assert (analysis.decode_model_flops(cfg, batch)
                == ranalysis.decode_model_flops(rcfg, batch))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("reduced", [False, True])
def test_input_specs_match_reference(shape, reduced):
    for arch in ("llama3.2-1b", "whisper-medium", "internvl2-1b"):
        port = input_specs(configs.get(arch), shape, reduced=reduced)
        ref = rinput_specs(rconfigs.get(arch), shape, reduced=reduced)
        assert list(port) == list(ref)
        for k, v in port.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == ref[k].shape and str(v.dtype)[6:] == str(ref[k].dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_model_on_meta(arch):
    cfg = configs.get(arch).reduced()
    meta = T.param_specs(cfg)
    real = T.param_tree(T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    assert [(n, t.shape, t.dtype) for n, t in pytree.leaf_paths(meta)] == \
        [(n, t.shape, t.dtype) for n, t in pytree.leaf_paths(real)]
    assert all(t.device.type == "meta" for t in pytree.leaves(meta))


def test_init_leaves_draw_what_init_params_draws():
    cfg = configs.get("hymba-1.5b").reduced()
    real = dict(pytree.leaf_paths(T.param_tree(
        T.init_params(cfg, torch.Generator().manual_seed(3), device="cpu"))))
    drawn = {"/".join(p): t for p, t in T.init_leaves(cfg, torch.Generator().manual_seed(3),
                                                       device="cpu")}
    assert drawn.keys() == real.keys()
    assert all(torch.equal(drawn[n], real[n]) for n in real)


def test_sanitize_drops_an_axis_that_does_not_divide():
    """hymba's SSM in-proj (1600, 6482) on a 16-way 'model' axis: the
    column split is dropped, as the reference's."""
    pm = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    rm = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((16, 16)))
    cfg = configs.get("hymba-1.5b")
    wi = T.param_specs(cfg)["layers"][0]["ssm"]["in"]
    assert wi.shape[1] % 16
    got = M._sanitize(M.P(None, "model"), wi.shape, pm)
    assert tuple(got) == (None, None) == tuple(rmesh._sanitize(
        rmesh.P(None, "model"), wi.shape, rm))


def test_placements_and_local_index():
    """A tuple on one dim shards it over each named mesh dim, major to
    minor; the local index is the reference's ``devices_indices_map``
    slice for an even split."""
    from torch.distributed.tensor import Replicate, Shard

    pm = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 4, 2))
    assert M.placements(M.P(("pod", "data"), "model"), pm) == (Shard(0), Shard(0), Shard(1))
    assert M.placements(M.P(None, None), pm) == (Replicate(),) * 3
    for coords in ((0, 0, 0), (1, 2, 1), (1, 3, 0)):
        idx = M.local_index(M.P(("pod", "data"), "model"), (64, 10), pm, coords)
        row = (coords[0] * 4 + coords[1]) * 8
        assert idx == (slice(row, row + 8), slice(coords[2] * 5, coords[2] * 5 + 5))
    with pytest.raises(ValueError, match="follow the mesh's order"):
        M.placements(M.P(("data", "pod")), pm)
    with pytest.raises(ValueError, match="twice"):
        M.placements(M.P("data", "data"), pm)


def test_dp_axes_and_rule_errors():
    pm = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 16, 16))
    assert M.dp_axes(pm) == rmesh.dp_axes(types.SimpleNamespace(axis_names=pm.mesh_dim_names))
    with pytest.raises(ValueError, match="no partition rule for param a/b"):
        M._param_rule(("a", "b"), 2, configs.get("llama3.2-1b"))
    with pytest.raises(ValueError, match="no cache rule"):
        M.cache_specs_tree(configs.get("llama3.2-1b"), pm,
                           {"layers": {"x": torch.empty(2, device="meta")}})


def test_rule_tables_match_reference():
    from repro.models import sharding as rsharding

    for name in ("DEFAULT_RULES", "LONG_CONTEXT_RULES", "PURE_DP_RULES", "SERVE_MOE_RULES"):
        assert getattr(sharding, name) == getattr(rsharding, name), name


def test_shard_activation_is_a_no_op_outside_rules():
    x = torch.randn(4, 8)
    assert not sharding.rules_active()
    assert sharding.shard_activation(x, ("act_batch", None)) is x
    pm = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    with sharding.use_rules(pm, sharding.PURE_DP_RULES):
        assert sharding.rules_active()
        assert sharding.shard_activation(x, ("act_batch", None)) is x   # a plain tensor
    assert not sharding.rules_active()


def test_reduce_scores_casts_through_bf16_under_rules():
    """The reference's ``_reduce_scores``: exact outside rules, the scores
    rounded to bf16 inside (after their cross-shard sum, which a plain
    tensor does not have)."""
    s = torch.randn(2, 3, 4, 64, dtype=torch.float32)
    assert engine._reduce_scores(s) is s
    pm = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    with sharding.use_rules(pm):
        got = engine._reduce_scores(s)
    assert got.dtype == torch.float32 and torch.equal(got, s.to(torch.bfloat16).float())
    assert not torch.equal(got, s)
    ref = np.asarray(jax.numpy.asarray(s.numpy()).astype(jax.numpy.bfloat16)
                     .astype(jax.numpy.float32))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_batch_mean_outside_a_split_is_the_mean():
    x = torch.randn(3, 5, 7)
    assert torch.equal(sharding.batch_mean(x, (0, 1)), x.mean(dim=(0, 1)))
    with sharding.split_batch([], 1):
        assert torch.equal(sharding.batch_mean(x, (0, 1)), x.mean(dim=(0, 1)))


def test_ef_spec_is_split_over_pod():
    cfg = dataclasses.replace(configs.get("llama3.2-1b").reduced(), fsdp=True)
    pm = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 2, 2))
    specs = S.state_specs(cfg, S.state_template(cfg, ef_planes=1), pm)
    for (name, ef), (_, p) in zip(pytree.leaf_paths(specs["ef"]),
                                  pytree.leaf_paths(specs["params"])):
        assert tuple(ef) == ("pod",) + tuple(p), name
    assert tuple(specs["opt"].step) == ()
