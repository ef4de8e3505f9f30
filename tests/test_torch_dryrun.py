"""repro_torch's dry-run: rank 0's sharded step, prefill or decode step on
fake tensors over a fake process group.

``launch/dryrun.py::lower_cell`` runs a reduced train cell of every family
(dense, MoE, SSM, hybrid, audio, VLM) on a fake (2, 2) mesh here: it must complete without launching a
kernel and without a real collective, and its argument bytes must be the
spec arithmetic (rank 0's shard of every state leaf plus its batch rows).
A serving cell of every family runs rank 0's sharded prefill or decode
step (``OK``), a ``long_500k`` cell (the window's slots over 'data',
``LONG_CONTEXT_RULES``) among them.  Its ``ideal_bytes_per_device`` is the
reference's arithmetic over its specs (``repro/launch/dryrun.py:199-204``),
but for an SSM state whose heads the 'model' axis does not divide, which
the engine splits as its layers split the heads.  On this CPU-only build the
fake tensors are CPU tensors (autograd on fake CUDA tensors needs a CUDA
build); on the card the dry-run's default is ``--device cuda``.
"""
import json
import math
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as rconfigs
from repro.launch import mesh as rmesh
from repro.models import transformer as RT
from repro.roofline import analysis as ranalysis
from repro.serve import engine as rengine
from repro_torch import configs
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.core import pytree
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, mesh as M
from repro_torch.serve import engine
from repro_torch.train import step as S

TRAIN_CELLS = ["llama3.2-1b", "deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b",
               "whisper-medium", "internvl2-1b"]
# a tensor-parallel rank's flops under 6 N D / 4 where N counts weights no
# matmul reads on each of the D tokens (measured 0.91x mamba2-1.3b, whose
# untied embedding, a quarter of its N, is a lookup; 0.81x whisper-medium,
# whose encoder reads its 24 frames, not the 64 tokens)
TRAIN_FLOOR = {"mamba2-1.3b": 0.85, "whisper-medium": 0.75}


def _spec_bytes(arch, shape=(2, 2)):
    """Rank 0's state and batch bytes from the specs alone."""
    cfg = configs.get(arch).reduced()
    pm = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)
    template = S.state_template(cfg)
    specs = S.state_specs(cfg, template, pm)
    total = 0
    for leaf, spec in zip(pytree.leaves(template), pytree.leaves(specs)):
        total += math.prod(M.local_shape(spec, leaf.shape, pm)) * leaf.element_size()
    batch = input_specs(cfg, "train_4k", reduced=True)
    total += sum(v.numel() * v.element_size() // shape[0] for v in batch.values())
    return total


@pytest.mark.parametrize("arch", TRAIN_CELLS)
def test_reduced_train_cell_on_a_fake_mesh(arch):
    ops.reset_launch_counts()
    rec = dryrun.lower_cell(arch, "train_4k", reduced=True, mesh_shape=(2, 2), device="cpu")
    assert not dist.is_initialized()                     # the fake group is gone
    assert not any(ops.launch_counts().values())
    assert rec["status"] == "OK" and rec["mesh"] == "2x2" and rec["ops"] > 100
    assert rec["memory"]["argument_size_in_bytes"] == _spec_bytes(arch)
    assert rec["memory"]["temp_size_in_bytes"] > 0
    rl = rec["roofline"]
    cfg = configs.get(arch).reduced()
    assert rl["model_flops_global"] == ranalysis.train_model_flops(rconfigs.get(arch).reduced(),
                                                                   64 * 4)
    # rank 0 runs its half of the batch forward and backward, tensor-parallel
    # through its half of each 'model'-split matmul, so at least 6 N D / 4
    # (but for the cells of TRAIN_FLOOR) and about 1x of a quarter of the
    # model's flops (measured 1.32x llama3.2-1b, 1.04x deepseek-moe-16b,
    # 1.06x hymba-1.5b, 1.47x internvl2-1b: the flash recompute and the
    # embedding's N, which no matmul reads, beside it; the step before it,
    # redundant along 'model' with remat off, 2.64x and 2.08x)
    floor = TRAIN_FLOOR.get(arch, 1.0)
    assert rl["flops_per_device"] >= floor * 6 * cfg.active_param_count() * 64 * 4 / 4
    assert rl["flops_per_device"] < 1.5 * rl["model_flops_global"] / 4
    by_axis = rl["collectives_by_axis"]
    assert by_axis["model"]["all-gather"] > 0 and by_axis["data"]["all-reduce"] > 0
    assert rl["collectives"]["all-gather"] == sum(v["all-gather"] for v in by_axis.values())
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    # the memory floor: arguments read once, temporaries at their peak
    # written once; every eager op's bytes are the ceiling beside it
    mem = rec["memory"]
    assert rl["hbm_bytes_per_device"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert rl["hbm_bytes_eager_per_device"] > rl["hbm_bytes_per_device"]
    json.dumps(rec)


def test_compressed_and_pure_dp_cells():
    rec = dryrun.lower_cell("llama3.2-1b", "train_4k", reduced=True, multi_pod=True,
                            mesh_shape=(2, 1, 2), grad_compress=1, device="cpu")
    assert rec["status"] == "OK" and rec["grad_compress"] == 1
    assert rec["roofline"]["collectives_by_axis"]["pod"]["all-gather"] > 0
    dp = dryrun.lower_cell("llama3.2-1b", "train_4k", reduced=True, mesh_shape=(2, 2),
                           parallelism="dp", device="cpu")
    assert dp["status"] == "OK"
    # replicated parameters: nothing is gathered, the gradient all-reduced
    assert dp["roofline"]["collectives"]["all-gather"] == 0
    assert dp["memory"]["argument_size_in_bytes"] > _spec_bytes("llama3.2-1b")


@pytest.mark.parametrize("arch,shape,kv_mode,serve_layout,reduced,status", [
    ("deepseek-moe-16b", "decode_32k", "dense", False, False, "OK"),
    ("llama3.2-1b", "decode_32k", "compressed", False, False, "OK"),
    ("hymba-1.5b", "decode_32k", "compressed", False, False, "OK"),
    ("whisper-medium", "decode_32k", "dense", False, False, "OK"),
    ("mamba2-1.3b", "long_500k", "dense", False, False, "OK"),
    ("h2o-danube-1.8b", "long_500k", "dense", False, False, "OK"),
    ("hymba-1.5b", "long_500k", "compressed", False, False, "OK"),
    # the plain flash version's 64 x 32 chunk pairs a layer at S 32768 take
    # ~10 min on fake CPU tensors: the prefill cell runs reduced on (2, 2)
    ("llama3.2-1b", "prefill_32k", "dense", False, True, "OK"),
    ("deepseek-moe-16b", "decode_32k", "compressed", True, False, "OK"),
])
def test_serving_cells_trace_or_skip_with_the_reference_ideal_bytes(arch, shape, kv_mode,
                                                                     serve_layout, reduced,
                                                                     status):
    """The serving cells trace rank 0's sharded prefill or decode step
    (``OK``, a decode cell with its floor fraction; ``long_500k`` under
    ``LONG_CONTEXT_RULES``, the batch of 1 whole, the window's slots over
    'data' and their partial softmaxes merged over it: an all-reduce over
    'data' in every attention layer).  ``ideal_bytes_per_device`` is the
    reference's arithmetic over its specs
    (``repro/launch/dryrun.py:199-204``), but for hymba-1.5b's SSM state:
    its 50 heads do not divide the 16-way 'model' axis, so the reference
    keeps it whole, and the engine splits it in chunks of 4 heads (rank 0
    holds 4)."""
    ops.reset_launch_counts()
    mesh_shape = (2, 2) if reduced else (16, 16)
    rec = dryrun.lower_cell(arch, shape, kv_mode=kv_mode, serve_layout=serve_layout,
                            reduced=reduced, mesh_shape=mesh_shape, device="cpu")
    assert not dist.is_initialized() and not any(ops.launch_counts().values())
    assert rec["status"] == status
    rcfg = rconfigs.get(arch).reduced() if reduced else rconfigs.get(arch)
    rm = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(mesh_shape))
    params = RT.param_specs(rcfg)
    seq, batch = SHAPES[shape]["seq_len"], SHAPES[shape]["global_batch"]
    if reduced:
        seq, batch = min(seq, 64), min(batch, 4)
    assert rec["ideal_bytes_per_device"] == _reference_ideal_bytes(
        rcfg, shape, kv_mode, serve_layout, rm, seq, batch)
    rl = rec["roofline"]
    if shape == "long_500k" and rcfg.sliding_window:
        assert rl["collectives_by_axis"]["data"]["all-reduce"] > 0
    cfg = configs.get(arch).reduced() if reduced else configs.get(arch)
    assert rec["kind"] == SHAPES[shape]["kind"] and rec["ops"] > 100
    if rec["kind"] == "decode":
        assert rl["model_flops_global"] == ranalysis.decode_model_flops(rcfg, batch)
        assert 0 < rl["floor_fraction"] <= 1
        # the float32 scores over the cache's window are all-reduced over
        # 'model' and rounded to bf16 after, as the reference's compiled step
        # does (its HLO's score all-reduce is f32:
        # tests/test_torch_long_context_families.py), a step's hot collective
        b, item = batch // mesh_shape[0], 2
        scores = cfg.n_layers * b * cfg.n_heads * engine.cache_window(cfg, seq) * 4
        got = rl["collectives_by_axis"]["model"]["all-reduce"]
        assert got >= scores
        if shape == "decode_32k" and cfg.family == "dense":
            # and the two row-parallel outputs a layer and the embedding's rows
            assert got == scores + (2 * cfg.n_layers + 1) * b * cfg.d_model * item
    else:
        assert rl["model_flops_global"] == 2.0 * rcfg.active_param_count() * seq * batch
        assert "floor_fraction" not in rl
    # the memory floor reads the parameters, the batch rows (and the cache) once
    assert rec["memory"]["argument_size_in_bytes"] >= (
        rec["ideal_bytes_per_device"] if rec["kind"] == "decode" else 0)
    json.dumps(rec)


def _reference_ideal_bytes(rcfg, shape, kv_mode, serve_layout, rm, seq, batch) -> float:
    """The parameters and cache a device holds, by the reference's specs and
    arithmetic; an SSM state whose heads do not divide 'model' counted at
    rank 0's ceil(H / n) heads, as the engine holds it."""
    params = RT.param_specs(rcfg)
    cache = rengine.cache_specs(rcfg, batch, seq, kv_mode=kv_mode, num_planes=1)
    pspecs = (rmesh.serve_param_specs_tree(rcfg, params, rm) if serve_layout
              else rmesh.param_specs_tree(rcfg, params, rm))
    long_ctx = shape == "long_500k"
    cspecs = rmesh.cache_specs_tree(rcfg, rm, cache, long_context=long_ctx)
    got = (ranalysis.sharded_bytes_per_device(params, pspecs, rm)
           + ranalysis.sharded_bytes_per_device(cache, cspecs, rm))
    n = dict(zip(rm.axis_names, rm.devices.shape))["model"]
    state = cache["layers"].get("state")
    if state is not None and state.shape[2] % n:
        whole = ranalysis.sharded_bytes_per_device({"s": state}, {"s": cspecs["layers"]["state"]},
                                                   rm)
        got += whole * (-(-state.shape[2] // n) / state.shape[2] - 1)
    return got


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b", "whisper-medium", "internvl2-1b"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("kv_mode", ["dense", "compressed"])
def test_ssm_hybrid_audio_and_vlm_serving_cells_trace(arch, shape, kv_mode):
    """Every ``prefill_32k``/``decode_32k`` cell of the SSM, hybrid, audio
    and VLM families, reduced on a fake (2, 2) mesh, traces rank 0's
    sharded prefill or decode step (``OK``) with the reference's ideal
    bytes: on (2, 2) the reduced SSM's 8 heads divide 'model'."""
    ops.reset_launch_counts()
    rec = dryrun.lower_cell(arch, shape, kv_mode=kv_mode, reduced=True, mesh_shape=(2, 2),
                            device="cpu")
    assert not dist.is_initialized() and not any(ops.launch_counts().values())
    assert rec["status"] == "OK" and rec["ops"] > 50, rec
    rm = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((2, 2)))
    seq, batch = min(SHAPES[shape]["seq_len"], 64), min(SHAPES[shape]["global_batch"], 4)
    assert rec["ideal_bytes_per_device"] == _reference_ideal_bytes(
        rconfigs.get(arch).reduced(), shape, kv_mode, False, rm, seq, batch)
    rl = rec["roofline"]
    assert rl["flops_per_device"] > 0 and rl["collectives_by_axis"]["model"]["all-gather"] > 0
    assert ("floor_fraction" in rl) == (shape == "decode_32k")
    json.dumps(rec)


def test_shape_skips_and_an_existing_group():
    rec = dryrun.lower_cell("llama3.2-1b", "long_500k", device="cpu")
    assert rec["status"] == "SKIP"
    assert rec["reason"] == configs.get("llama3.2-1b").shape_skips["long_500k"]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.lower_cell("llama3.2-1b", "train_4k", reduced=True, device="cpu")
    finally:
        dist.destroy_process_group()


def test_main_writes_a_record(tmp_path, capsys):
    for shape, status, tally in (("decode_32k", "OK", "1 OK, 0 SKIP"),
                                 ("long_500k", "OK", "1 OK, 0 SKIP")):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "mamba2-1.3b", "--shape", shape, "--device", "cpu",
                         "--out", str(tmp_path)])
        assert e.value.code == 0
        out = capsys.readouterr().out
        assert f"[{status}] mamba2-1.3b|{shape}|single" in out and f"{tally}, 0 FAIL" in out
        rec = json.loads((tmp_path / f"mamba2-1.3b.{shape}.single.json").read_text())
        assert rec["status"] == status
        assert rec["ideal_bytes_per_device"] > 0 and rec["wall_s"] >= 0


def test_main_passes_serve_layout_and_names_its_record(tmp_path, capsys, monkeypatch):
    """``--serve-layout`` reaches ``lower_cell`` and its record's file name
    carries it, beside ``--kv-mode``'s."""
    seen = []

    def lower(arch, shape, **kw):
        seen.append(kw)
        return {"arch": arch, "shape": shape, "status": "SKIP", "reason": "stub"}

    monkeypatch.setattr(dryrun, "lower_cell", lower)
    for flags, name in (([], "deepseek-moe-16b.decode_32k.single.compressed.json"),
                        (["--serve-layout"],
                         "deepseek-moe-16b.decode_32k.single.compressed.serve_layout.json")):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "deepseek-moe-16b", "--shape", "decode_32k", "--kv-mode",
                         "compressed", "--out", str(tmp_path), *flags])
        assert e.value.code == 0 and "0 OK, 1 SKIP, 0 FAIL" in capsys.readouterr().out
        assert seen[-1]["serve_layout"] == bool(flags) and seen[-1]["kv_mode"] == "compressed"
        assert json.loads((tmp_path / name).read_text())["reason"] == "stub"


def test_make_production_mesh_is_a_function():
    """Importing the modules makes no group; the production mesh needs its
    256 (512) ranks."""
    import importlib

    importlib.reload(M)
    assert not dist.is_initialized()
    dryrun.fake_process_group(512)
    try:
        mesh = M.make_production_mesh(multi_pod=True, device_type="cpu")
        assert mesh.mesh_dim_names == ("pod", "data", "model") and tuple(mesh.shape) == (2, 16, 16)
        assert M.dp_axes(mesh) == ("pod", "data")
    finally:
        dist.destroy_process_group()
    assert torch.distributed.is_available()
