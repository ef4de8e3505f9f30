"""repro_torch compressed collectives and the GPipe schedule against the JAX
package's, on gloo process groups on the CPU.

Four worker processes form a gloo group (a ``FileStore`` under the test's
temporary directory: no TCP port to collide between test workers) with two
subgroups of two ranks.  They run ``compressed_psum_mean`` (two steps with
error feedback), ``compressed_ppermute``, ``compressed_all_to_all`` and
``pipeline_apply`` on inputs made with numpy from a seed.  The reference runs
the same in one subprocess with 4 host devices, concurrently: the pipelines
and a partial permutation under ``shard_map`` over a mesh axis, as
tests/test_grad_compress.py runs them; the other collectives under
``jax.vmap`` over a named axis, which runs the same reference functions op
by op like ``shard_map``'s eager run (bit-identical to it) but dispatches
each primitive once instead of once per device, about four times faster.  The collectives
must match bit for bit.  So must the pipeline on stages whose float32 result
is exact on both sides (``x * a + b``, ``a`` a power of two); on the
reference's ``tanh(x @ p)`` stages, whose matmul XLA and torch round
differently in the last bits, it is held within a measured tolerance.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import grad_compress as rgc
from repro_torch.core import grad_compress as tgc

ROOT = Path(__file__).resolve().parent.parent
# (name, members, num_planes, block); two-member runs use ranks {0, 1} and {2, 3}
PSUM = [("psum4_p1_b64", 4, 1, 64), ("psum2_p3_b32", 2, 3, 32)]
RING = [(i, (i + 1) % 4) for i in range(4)]
PARTIAL = [(0, 2), (1, 3)]
PERMUTES = [("ring_p3", RING, 3), ("ring_p1", RING, 1), ("partial_p1", PARTIAL, 1)]
ALL_TO_ALL = [("a2a_01_p3", 0, 1, 3), ("a2a_10_p2", 1, 0, 2), ("a2a_neg_p1", -3, -2, 1)]
# the pipeline on exact stages: (name, members, num_planes or None for raw)
PIPE_EXACT = [("pipe4x_raw", 4, None), ("pipe4x_p1", 4, 1), ("pipe4x_p3", 4, 3),
              ("pipe2x_raw", 2, None), ("pipe2x_p2", 2, 2)]
# the pipeline's tolerance to the reference on the tanh(x @ p) stages, whose
# float32 matmul XLA and torch round differently in the last bits: a one-ulp
# change can move a quantized value across a rounding boundary of the planes,
# one step (about 1.2e-7 at P = 3, 3e-5 at P = 2), and later stages carry it
# on.  The measured maxima on these inputs (torch 2.13 and jax 0.9 on an
# x86-64 CPU) are 1.94e-7, 2.38e-7 and 8.15e-6; each limit is about twice its
# measured maximum.  These cases cannot tell a compressed shift from a raw
# one at P = 3 (the compression moves the output by 2.4e-7 here): the exact
# stages below hold the compressed pipeline to the reference bit for bit
PIPE_ATOL = {"pipe4_raw": 4e-7, "pipe4_p3": 5e-7, "pipe2_p2": 2e-5}


def _inputs(path: Path) -> None:
    rng = np.random.default_rng(2024)
    np.savez(
        path,
        gw=(rng.standard_normal((4, 3, 130)) * 0.01).astype(np.float32),
        gb=(rng.standard_normal((4, 70)) * np.exp2(rng.integers(-20, 0, (4, 1)))).astype(np.float32),
        gs=rng.standard_normal(4).astype(np.float32),
        xp=rng.normal(size=(4, 8, 64)).astype(np.float32),
        xa=rng.normal(size=(4, 8, 12, 64)).astype(np.float32),
        ws=(rng.normal(size=(4, 64, 64)) * 0.1).astype(np.float32),
        xs=rng.normal(size=(8, 2, 64)).astype(np.float32),
        # exact stages x * a + b: a in {1/2, 1, 2}, b integers.  The blocks
        # the real microbatches shift have exponents 13 .. 16, inside 10 .. 18,
        # where the reference's exp2(+-sexp) is an exact power of two at
        # P = 1 .. 3, so its jitted decode (one FMA) and the port's (two
        # roundings) agree
        wx=np.stack([np.exp2(rng.integers(-1, 2, (4, 64))),
                     rng.integers(-4096, 4097, (4, 64))], axis=1).astype(np.float32),
        xx=(rng.uniform(-1, 1, (8, 2, 64)) * 8192).astype(np.float32),
    )


REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PS
from repro.compat import shard_map
from repro.core import grad_compress as gc
from repro.pipeline_par import pipeline_apply

PSUM, PERMUTES, ALL_TO_ALL, PIPE_EXACT = {psum!r}, {permutes!r}, {a2a!r}, {pipe_exact!r}
d = dict(np.load(sys.argv[1]))
out = {{}}

def named(fn, *args):
    return np.asarray(jax.vmap(fn, axis_name="x")(*args))

def psum(w, b, s, P, block):
    def fn(w, b, s):
        g = {{"w": w, "b": {{"bias": b}}, "s": s}}
        mean, res = gc.compressed_psum_mean(g, "x", num_planes=P, block=block)
        return (mean["w"], mean["b"]["bias"], mean["s"], res["w"], res["b"]["bias"], res["s"])
    return [np.asarray(a) for a in jax.vmap(fn, axis_name="x")(w, b, s)]

for name, n, P, block in PSUM:
    res = []
    for lo in range(0, 4, n):
        g = [jnp.asarray(d[k][lo:lo + n]) for k in ("gw", "gb", "gs")]
        m1 = psum(*g, P, block)
        g2 = [a + jnp.asarray(r) for a, r in zip(g, m1[3:])]     # error feedback
        res.append(m1 + psum(*g2, P, block))
    keys = ["mean/w", "mean/b", "mean/s", "resid/w", "resid/b", "resid/s"]
    for i, key in enumerate([f"step1/{{k}}" for k in keys] + [f"step2/{{k}}" for k in keys]):
        out[f"{{name}}/{{key}}"] = np.concatenate([r[i] for r in res])

xp, xa = jnp.asarray(d["xp"]), jnp.asarray(d["xa"])
for name, perm, P in PERMUTES:
    if len(perm) == 4:
        out[name] = named(lambda x: gc.compressed_ppermute(x, "x", perm, num_planes=P), xp)
    else:                      # a partial permutation needs shard_map
        out[name] = np.asarray(shard_map(
            lambda x: gc.compressed_ppermute(x[0], "x", perm, num_planes=P)[None],
            mesh=Mesh(np.array(jax.devices()), ("x",)), in_specs=(PS("x"),),
            out_specs=PS("x"), axis_names={{"x"}}, check_vma=False)(xp))
out["ring_raw"] = named(lambda x: jax.lax.ppermute(x, "x", PERMUTES[0][1]), xp)
for name, sa, ca, P in ALL_TO_ALL:
    out[name] = named(lambda x: gc.compressed_all_to_all(x, "x", sa, ca, num_planes=P), xa)
out["a2a_raw"] = named(lambda x: jax.lax.all_to_all(x, "x", 0, 1, tiled=True), xa)

stage = lambda p, x: jnp.tanh(x @ p)
ws, xs = jnp.asarray(d["ws"]), jnp.asarray(d["xs"])
smesh4 = Mesh(np.array(jax.devices()), ("stage",))
smesh2 = Mesh(np.array(jax.devices()[:2]), ("stage",))
# every rank returns the last stage's outputs: stack them per rank
out["pipe4_raw"] = np.stack([pipeline_apply(stage, smesh4)(ws, xs)] * 4)
out["pipe4_p3"] = np.stack([pipeline_apply(
    stage, smesh4, compress_activations=True, num_planes=3)(ws, xs)] * 4)
two = [pipeline_apply(stage, smesh2, compress_activations=True, num_planes=2)(ws[lo:lo + 2], xs)
       for lo in (0, 2)]
out["pipe2_p2"] = np.stack([two[0], two[0], two[1], two[1]])
exact = lambda p, x: x * p[0] + p[1]
wx, xx = jnp.asarray(d["wx"]), jnp.asarray(d["xx"])
for name, n, P in PIPE_EXACT:
    kw = {{}} if P is None else dict(compress_activations=True, num_planes=P)
    mesh = smesh4 if n == 4 else smesh2
    runs = [np.asarray(pipeline_apply(exact, mesh, **kw)(wx[lo:lo + n], xx)) for lo in range(0, 4, n)]
    out[name] = np.stack([r for r in runs for _ in range(n)])
np.savez(sys.argv[2], **out)
print("REFERENCE-OK")
"""

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import grad_compress as gc
from repro_torch.kernels import ref
from repro_torch.pipeline_par import pipeline_apply

PSUM, PERMUTES, ALL_TO_ALL, PIPE_EXACT = {psum!r}, {permutes!r}, {a2a!r}, {pipe_exact!r}
rank, store, inputs, dest = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
pair = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
d = {{k: torch.from_numpy(v) for k, v in np.load(inputs).items()}}
out = {{}}
for name, n, P, block in PSUM:
    group = None if n == 4 else pair
    g = {{"w": d["gw"][rank], "b": {{"bias": d["gb"][rank]}}, "s": d["gs"][rank]}}
    for step in (1, 2):
        mean, res = gc.compressed_psum_mean(g, group, num_planes=P, block=block)
        for part, t in (("mean", mean), ("resid", res)):
            for k, v in (("w", t["w"]), ("b", t["b"]["bias"]), ("s", t["s"])):
                out[f"{{name}}/step{{step}}/{{part}}/{{k}}"] = v.numpy()
        g = {{"w": ref.flush(g["w"] + res["w"]), "b": {{"bias": ref.flush(g["b"]["bias"] + res["b"]["bias"])}},
              "s": ref.flush(g["s"] + res["s"])}}
for name, perm, P in PERMUTES:
    out[name] = gc.compressed_ppermute(d["xp"][rank], None, perm, num_planes=P).numpy()
for name, sa, ca, P in ALL_TO_ALL:
    out[name] = gc.compressed_all_to_all(d["xa"][rank], None, sa, ca, num_planes=P).numpy()
stage = lambda p, x: torch.tanh(x @ p)
out["pipe4_raw"] = pipeline_apply(stage)(d["ws"][rank], d["xs"]).numpy()
out["pipe4_p3"] = pipeline_apply(stage, compress_activations=True, num_planes=3)(d["ws"][rank], d["xs"]).numpy()
out["pipe2_p2"] = pipeline_apply(stage, pair, compress_activations=True, num_planes=2)(d["ws"][rank], d["xs"]).numpy()
exact = lambda p, x: x * p[0] + p[1]
for name, n, P in PIPE_EXACT:
    kw = {{}} if P is None else dict(compress_activations=True, num_planes=P)
    out[name] = pipeline_apply(exact, None if n == 4 else pair, **kw)(d["wx"][rank], d["xx"]).numpy()
np.savez(dest, **out)
dist.destroy_process_group()
print("WORKER-OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Reference and port outputs of the same inputs: ``(ref, port)`` where
    ``port[key]`` stacks the four ranks' outputs like the reference's."""
    tmp = tmp_path_factory.mktemp("collectives")
    _inputs(tmp / "in.npz")
    cases = dict(psum=PSUM, permutes=PERMUTES, a2a=ALL_TO_ALL, pipe_exact=PIPE_EXACT)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE.format(**cases), str(tmp / "in.npz"), str(tmp / "ref.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)]
    for r in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER.format(**cases), str(r), str(tmp / "store"),
             str(tmp / "in.npz"), str(tmp / f"rank{r}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    logs = []
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for log, tag in zip(logs, ["REFERENCE-OK"] + ["WORKER-OK"] * 4):
        assert tag in log, log[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    port = {k: np.stack([rk[k] for rk in ranks]) for k in ranks[0]}
    return ref, port


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("name", [p[0] for p in PSUM])
def test_psum_mean_with_error_feedback_is_bit_identical(runs, name):
    ref, port = runs
    keys = [k for k in ref if k.startswith(name + "/")]
    assert len(keys) == 12
    for k in keys:
        assert _same(port[k], ref[k]), k
    # the mean is the same on every member, and step 2 saw the residual
    assert all(_same(port[f"{name}/step1/mean/w"][i], port[f"{name}/step1/mean/w"][0])
               for i in range(2 if name.startswith("psum2") else 4))
    assert not _same(port[f"{name}/step1/mean/w"], port[f"{name}/step2/mean/w"])


@pytest.mark.parametrize("name", [p[0] for p in PERMUTES] + [a[0] for a in ALL_TO_ALL])
def test_ppermute_and_all_to_all_are_bit_identical(runs, name):
    ref, port = runs
    assert _same(port[name], ref[name]), name


def test_collectives_track_the_raw_exchange(runs):
    """The reference's own criteria: at P = 3 the compressed exchange is
    within 0.05 of the raw one; members outside a partial perm get zeros."""
    ref, port = runs
    assert np.abs(port["ring_p3"] - ref["ring_raw"]).max() < 0.05
    assert np.abs(port["a2a_01_p3"] - ref["a2a_raw"]).max() < 0.05
    assert not port["partial_p1"][:2].any() and port["partial_p1"][2:].any()


@pytest.mark.parametrize("name", sorted(PIPE_ATOL))
def test_pipeline_matches_reference(runs, name):
    ref, port = runs
    np.testing.assert_allclose(port[name], ref[name], rtol=0, atol=PIPE_ATOL[name])
    assert np.abs(port["pipe4_p3"] - port["pipe4_raw"]).max() < 0.05


@pytest.mark.parametrize("name", [p[0] for p in PIPE_EXACT])
def test_pipeline_is_bit_identical_on_exact_stages(runs, name):
    """On stages whose float32 result is exact on both sides, the pipeline
    matches the reference bit for bit, raw and compressed.  A compressed run
    differs from the raw run of the same stages (the only difference between
    them is the planes round trip of each shift; measured maxima: 1116 at
    P = 1, 0.998 at P = 2, 0.0234 at P = 3), so a pipeline that skipped the
    compression could not pass."""
    ref, port = runs
    assert _same(port[name], ref[name]), name
    if not name.endswith("_raw"):
        raw = port[name.split("_")[0] + "_raw"]
        assert np.abs(port[name] - raw).max() > 0, name


def test_all_to_all_rejects_the_blocked_axis():
    with pytest.raises(ValueError, match="blocked last axis"):
        rgc.compressed_all_to_all(np.zeros((4, 8, 64), np.float32), "x", 0, 2)
    with pytest.raises(ValueError, match="blocked last axis"):
        tgc.compressed_all_to_all(torch.zeros((4, 8, 64)), None, 0, 2)
    with pytest.raises(ValueError, match=r"needs >= 2 dims \(last = blocks\)"):
        tgc.compressed_all_to_all(torch.zeros(64), None, 0, 0)


def test_wire_bytes_per_value_matches_reference():
    for P in (1, 2, 3):
        for block in (32, 64, 128):
            assert tgc.wire_bytes_per_value(P, block) == rgc.wire_bytes_per_value(P, block)
    assert tgc.wire_bytes_per_value(1) < 4.0 / 3.6
