"""Multi-pod dry-run harness with an H100 roofline.

Counterpart of ``repro/launch/dryrun.py``.  For a train cell it runs rank
0's sharded training step (``train.step.make_train_step(mesh=...)``:
tensor-parallel along 'model' for every family) under
``FakeTensorMode`` on a fake process group of ``mesh.size`` ranks: the
state, the batch and every intermediate are fake tensors (shape, dtype and
device only), every collective is a no-op of the fake group, and the
kernels' custom operators give shapes without launching.  An
``OpCounter`` (``roofline/hlo_cost.py``) counts each op that runs, so the
record holds the per-device flops, bytes and collective bytes of one step
and the H100 roofline terms (``roofline/analysis.py``, data-sheet
constants).  Nothing is allocated at full size; the reference sets
``XLA_FLAGS`` at import, the port makes its fake group inside
:func:`lower_cell` and destroys it after.

A ``prefill``/``decode`` cell of every family runs rank 0's sharded
``engine.prefill``/``engine.decode_step`` the same way, inside the
rule table the reference's ``lower_cell`` picks for the cell
(``DEFAULT_RULES``, ``LONG_CONTEXT_RULES`` for ``long_500k``,
``PURE_DP_RULES`` for ``parallelism="dp"``, ``SERVE_MOE_RULES`` over it
with ``serve_layout``; the training step picks its own): the parameters
placed by ``param_specs_tree`` (``serve_param_specs_tree`` with
``serve_layout``, replicated with ``dp``), the cache as the engine keeps it
(``mesh.serve_cache_specs``: ``cache_specs_tree``'s layout -- under
``LONG_CONTEXT_RULES`` the batch whole and the window's W slots over
'data' -- but for an SSM state whose heads do not divide the ``model``
axis, split as the layers split its heads).  Each serving record holds
``ideal_bytes_per_device`` -- the parameters and the cache rank 0 holds --
and a decode record (``long_500k``'s among them) its ``floor_fraction``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
  ... --multi-pod           (2,16,16) pod/data/model mesh
  ... --kv-mode compressed  SZx-planes KV cache for decode cells
  ... --grad-compress 1     SZx cross-pod gradient compression (multi-pod)
  ... --device cpu          fake CPU tensors (the flash and planes plain
                            versions' ops are counted in place of the kernels')
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch import configs
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.roofline import analysis as roofline

def fake_process_group(world_size: int):
    """Rank 0 of a fake default process group of ``world_size`` ranks: its
    collectives return at once and move nothing."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg); the dry-run "
                           "needs one") from e
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group; a default "
                           "process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def fake_state(cfg, mesh, specs, template, device: str):
    """Rank 0's shards of a state ``template`` (``meta`` tensors) as
    ``DTensor``s of fake tensors placed by ``specs``; call under
    ``FakeTensorMode``."""
    import torch

    from repro_torch.core.pytree import tree_map

    def leaf(t, spec):
        local = torch.empty(mesh_lib.local_shape(spec, t.shape, mesh), dtype=t.dtype,
                            device=device)
        return mesh_lib.from_local(local, spec, t.shape, mesh)

    return tree_map(leaf, template, specs)


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    kv_mode: str = "dense",
    num_planes: int = 1,
    grad_compress: int = 0,
    remat: bool | None = None,
    parallelism: str = "tp",        # "tp" (baseline) | "dp" (small models)
    serve_layout: bool = False,     # decode-oriented weight layout
    serve_bf16: bool = False,       # bf16 serving weights
    device: str = "cuda",
    reduced: bool = False,
    mesh_shape: tuple | None = None,
):
    """Run one cell on fake tensors; returns its record.  ``reduced`` takes
    the arch's reduced config and ``input_specs(reduced=True)``, and
    ``mesh_shape`` another mesh shape over the same axes (for tests)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.roofline import hlo_cost
    from repro_torch.serve import engine
    from repro_torch.train import step as train_step_mod

    from repro_torch.models import sharding

    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if shape_name in cfg.shape_skips:
        return {"arch": arch, "shape": shape_name, "status": "SKIP",
                "reason": cfg.shape_skips[shape_name]}

    spec = SHAPES[shape_name]
    kind = spec["kind"]
    shape, axes = mesh_lib.MESH_SHAPES[multi_pod]
    shape = tuple(mesh_shape or shape)
    batch = input_specs(cfg, shape_name, reduced=reduced)
    seq_len, global_batch = spec["seq_len"], spec["global_batch"]
    if reduced:                                   # input_specs' cut
        seq_len, global_batch = min(seq_len, 64), min(global_batch, 4)
    long_ctx = shape_name == "long_500k"
    rules = dict(sharding.LONG_CONTEXT_RULES if long_ctx else sharding.DEFAULT_RULES)
    if parallelism == "dp":
        rules = dict(sharding.PURE_DP_RULES)
    if serve_layout and cfg.n_experts:
        rules.update(sharding.SERVE_MOE_RULES)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(map(str, shape)),
        "kind": kind,
        "kv_mode": kv_mode if kind == "decode" else None,
        "grad_compress": grad_compress,
    }

    fake_process_group(math.prod(shape))
    try:
        mesh = torch.distributed.device_mesh.init_device_mesh(device, shape,
                                                              mesh_dim_names=axes)
        chips = mesh.size()

        def pspecs_of(tree):
            if parallelism == "dp":
                return mesh_lib.replicated_specs_tree(tree)
            if serve_layout:
                return mesh_lib.serve_param_specs_tree(cfg, tree, mesh)
            return mesh_lib.param_specs_tree(cfg, tree, mesh)

        if kind != "train":
            return {**rec, **_serve_cell(cfg, mesh, pspecs_of, rules, kind, batch, seq_len,
                                         global_batch, kv_mode, num_planes, serve_bf16,
                                         device)}

        from torch._subclasses.fake_tensor import FakeTensorMode

        opt = AdamW(lr=warmup_cosine(3e-4, 2000, 100000))
        template = train_step_mod.state_template(cfg, ef_planes=grad_compress)
        sspecs = train_step_mod.state_specs(cfg, template, mesh)
        if parallelism == "dp":
            sspecs = {**sspecs, "params": mesh_lib.replicated_specs_tree(template["params"]),
                      "opt": type(template["opt"])(
                          step=mesh_lib.P(),
                          m=mesh_lib.replicated_specs_tree(template["opt"].m),
                          v=mesh_lib.replicated_specs_tree(template["opt"].v))}
        bspecs = mesh_lib.batch_specs_tree(cfg, mesh, batch)
        arg_bytes = (roofline.sharded_bytes_per_device(template, sspecs, mesh)
                     + roofline.sharded_bytes_per_device(batch, bspecs, mesh))
        fn = train_step_mod.make_train_step(
            cfg, opt, mesh=mesh, compress_planes=grad_compress,
            batch_axes=tuple(mesh.mesh_dim_names) if parallelism == "dp" else None)
        if device == "cpu":
            # the plain planes versions' cached table, made real before the
            # fake mode so that the cache never holds a fake tensor
            from repro_torch.kernels import ref

            ref.planes_scale_table(device)
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            state = fake_state(cfg, mesh, sspecs, template, device)
            fake_batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                          for k, v in batch.items()}
            with hlo_cost.OpCounter(mesh) as counter:
                fn(state, fake_batch)
        t_trace = time.time() - t0
        rl = roofline.analyze(counter, model_flops=roofline.train_model_flops(
            cfg, seq_len * global_batch), chips=chips, argument_bytes=arg_bytes)
        return {**rec, "status": "OK", "trace_s": round(t_trace, 1), "ops": counter.ops,
                "memory": {"argument_size_in_bytes": arg_bytes,
                           "temp_size_in_bytes": float(counter.peak_live),
                           "peak_size_in_bytes": arg_bytes + counter.peak_live},
                "roofline": rl.to_dict()}
    finally:
        dist.destroy_process_group()


def _serve_cell(cfg, mesh, pspecs_of, rules, kind, batch, seq_len, global_batch, kv_mode,
                num_planes, serve_bf16, device) -> dict:
    """A prefill or decode cell's record (module docstring)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import sharding, transformer as T
    from repro_torch.roofline import hlo_cost
    from repro_torch.serve import engine

    params = T.param_specs(dataclasses.replace(cfg, param_dtype="bfloat16")
                           if serve_bf16 else cfg)
    pspecs = pspecs_of(params)
    cache = engine.cache_specs(cfg, global_batch, seq_len, kv_mode=kv_mode,
                               num_planes=num_planes)
    with sharding.use_rules(mesh, rules):
        cspecs = mesh_lib.serve_cache_specs(mesh, cache)
    ideal = (roofline.sharded_bytes_per_device(params, pspecs, mesh)
             + roofline.sharded_bytes_per_device(cache, cspecs, mesh))
    names = mesh.mesh_dim_names
    with sharding.use_rules(mesh, rules):
        rows = tuple(names[i] for i in sharding.mesh_dims("act_batch"))
    bspecs = {k: mesh_lib._sanitize(mesh_lib.P(rows or None, *((None,) * (v.dim() - 1))),
                                    v.shape, mesh) for k, v in batch.items()}
    arg_bytes = (roofline.sharded_bytes_per_device(params, pspecs, mesh)
                 + roofline.sharded_bytes_per_device(batch, bspecs, mesh)
                 + (roofline.sharded_bytes_per_device(cache, cspecs, mesh)
                    if kind == "decode" else 0))
    if device == "cpu":
        # the plain planes versions' cached table, made real before the fake
        # mode so that the cache never holds a fake tensor
        from repro_torch.kernels import ref

        ref.planes_scale_table(device)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fparams = fake_state(cfg, mesh, pspecs, params, device)
        inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in batch.items()}
        with sharding.use_rules(mesh, rules), hlo_cost.OpCounter(mesh) as counter:
            if kind == "prefill":
                engine.prefill(fparams, cfg, inputs["tokens"], frames=inputs.get("frames"),
                               image_embeds=inputs.get("image_embeds"), seq_len=seq_len,
                               kv_mode=kv_mode, num_planes=num_planes)
            else:
                fcache = {"pos": seq_len - 1,
                          **fake_state(cfg, mesh, {k: v for k, v in cspecs.items() if k != "pos"},
                                       {k: v for k, v in cache.items() if k != "pos"}, device)}
                engine.decode_step(fparams, cfg, fcache, inputs["token"], kv_mode=kv_mode,
                                   num_planes=num_planes)
    t_trace = time.time() - t0
    model_flops = (2.0 * cfg.active_param_count() * seq_len * global_batch
                   if kind == "prefill" else roofline.decode_model_flops(cfg, global_batch))
    rl = roofline.analyze(counter, model_flops=model_flops, chips=mesh.size(),
                          argument_bytes=arg_bytes)
    extra = {"ideal_bytes_per_device": ideal}
    if kind == "decode":
        extra["floor_fraction"] = roofline.decode_floor_fraction(ideal, rl)
    return {"status": "OK", "trace_s": round(t_trace, 1), "ops": counter.ops,
            "ideal_bytes_per_device": ideal,
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "temp_size_in_bytes": float(counter.peak_live),
                       "peak_size_in_bytes": arg_bytes + counter.peak_live},
            "roofline": {**rl.to_dict(), **extra}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--kv-mode", default="dense", choices=["dense", "compressed"])
    ap.add_argument("--num-planes", type=int, default=1)
    ap.add_argument("--grad-compress", type=int, default=0)
    ap.add_argument("--serve-layout", action="store_true",
                    help="serving cells: the decode-oriented weight layout "
                         "(serve_param_specs_tree, SERVE_MOE_RULES for the MoE)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (no card is needed for either)")
    ap.add_argument("--out", default=None, help="directory for per-cell JSON")
    args = ap.parse_args(argv)

    cells = []
    archs = configs.ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    results = []
    for a, s, mp in cells:
        tag = f"{a}|{s}|{'multi' if mp else 'single'}"
        t0 = time.time()
        try:
            rec = lower_cell(a, s, multi_pod=mp, kv_mode=args.kv_mode,
                             num_planes=args.num_planes, grad_compress=args.grad_compress,
                             serve_layout=args.serve_layout, device=args.device)
        except Exception as e:  # a failing cell is a bug: record + continue
            rec = {"arch": a, "shape": s, "mesh": "multi" if mp else "single",
                   "status": "FAIL", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        rec["wall_s"] = round(time.time() - t0, 1)
        results.append(rec)
        status = rec["status"]
        extra = ""
        if status == "OK":
            r = rec["roofline"]
            frac = r.get("floor_fraction", r["roofline_fraction"])
            extra = (f" trace={rec['trace_s']}s bottleneck={r['bottleneck']}"
                     f" frac={frac:.3f}"
                     f" args={rec['memory']['argument_size_in_bytes'] / 1e9:.2f}GB")
        elif status == "FAIL":
            extra = " " + rec["error"][:120]
        print(f"[{status}] {tag}{extra}", flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            suffix = "" if args.kv_mode == "dense" else f".{args.kv_mode}"
            if args.grad_compress:
                suffix += f".gc{args.grad_compress}"
            if args.serve_layout:
                suffix += ".serve_layout"
            fn = f"{a}.{s}.{'multi' if mp else 'single'}{suffix}.json"
            with open(os.path.join(args.out, fn), "w") as f:
                json.dump(rec, f, indent=1)

    n_ok = sum(r["status"] == "OK" for r in results)
    n_skip = sum(r["status"] == "SKIP" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"\n{n_ok} OK, {n_skip} SKIP, {n_fail} FAIL / {len(results)} cells")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
