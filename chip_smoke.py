#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--edge 512] [--reps 50]

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  It imports nothing of the JAX package.  In order it:

  1. prints the card's name and power limit, the torch and nvcc versions,
     and builds every kernel in src/repro_torch/csrc (one nvcc per source,
     started together), printing the build time;
  2. holds each kernel against its plain PyTorch version on the card, for
     f32/f64/f16/bf16, at the main path's frame shape (64 MiB frames,
     bs=128) and at edge shapes (bs=1, bs=100 with a ragged last block,
     bs=4096, an all-constant input, a frame with every L = 0, verbatim
     blocks, NaN/inf blocks, and lo/rb/rebase block ranges) -- every output
     bit-identical;
  3. reproduces the golden SHA-256 digests of the three f32 golden streams
     that use no transcendental function, through the kernel path;
  4. drives the main path at a size users run: an --edge^3 float32 field
     (512^3 = 512 MiB, the size of a Nyx snapshot) made on the card from
     --seed, through SZxCodec().compress/decompress, dump_chunked (64 MiB
     frames), load_chunked(n=), load_chunked(select=), decompress_range;
     checks max |x - x'| <= e on the card and one frame's bytes against the
     plain route; then f64/f16/bf16 chunked round trips of 64 MiB each.
     Launch counters are zeroed just before this phase and read just after;
  5. times each kernel (CUDA events, warmed up, --reps launches) and its
     plain version at the frame shape, beside the bound from bytes moved
     at 3.35 TB/s;
  6. breaks one 64 MiB frame's compress and decompress into their stages
     (host clock, synchronized around each stage).

Any failed check raises, so the exit code is non-zero.  The last two lines
are the kernels JSON and the result JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate (data sheet)
FRAME_BYTES = 64 << 20
GOLDEN_SHA256 = {                  # tests/test_codec.py, the f32 golden streams
    "walk_bs64_rel1e-3": "8268a4b101cb0f0008d5e1f0279de3021c5ed93d5de50f92ad1dd0c61f9bb1c9",
    "const_bs128": "b1e68c21ff4f2c1a2e782f54a8c46a151610398ac78ae536d3460f0e8a0879fd",
    "spiky_bs32_abs1e-5": "f47e60993b1aa622798eb1d605d066665e6aac9c32ec672d3fe817b601f6bcfd",
}


MAX_ERR = {"encode": 0.0, "decode_body": 0.0}   # kernel vs plain, this run


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def bits(t):
    """Tensor reinterpreted as signed integers of its own width (bit view)."""
    import torch

    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def same_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(bits(a), bits(b)))


def max_abs_diff(a, b) -> float:
    """max |a - b| over the positions where not both are NaN."""
    import torch

    if a.numel() == 0:
        return 0.0
    a, b = a.double(), b.double()
    d = (a - b).abs()
    return float(torch.where(torch.isnan(a) & torch.isnan(b), 0.0, d).max())


def walk(n, dtype, gen, scale=0.01):
    import torch

    steps = torch.randn(n, dtype=torch.float64, device="cuda", generator=gen)
    return (torch.cumsum(steps, 0) * scale).to(dtype)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernel against plain version
# ---------------------------------------------------------------------------

def encode_both(xb, e, spec):
    """Kernel and plain encode of the same blocks; asserts bit identity."""
    from repro_torch.kernels import encode as enc_mod, specs

    p_e = specs.exact_exponent_of(e)
    k = enc_mod.encode(xb, e, p_e, spec=spec)
    p = enc_mod.encode_plain(xb, e, spec, p_e)
    names = ("mu", "const", "reqlen", "shift", "nbytes", "planes", "L")
    for name, a, b in zip(names, k, p):
        check(same_bits(a, b), f"encode {spec.name} {tuple(xb.shape)}: {name} differs")
        MAX_ERR["encode"] = max(MAX_ERR["encode"], max_abs_diff(a, b))
    return k


def decode_both(body, nnc, lo, rb, rebase, spec, nb, bs):
    """Kernel and plain decode_body of one body; asserts bit identity and
    equal mid_total.  Returns the kernel's values and mid_total."""
    from repro_torch.kernels import decode as dec_mod, ref

    _c, mu, shift, nbytes, rank, _nnc_seen = ref.parse_body_ref(body, nnc, spec, nb)
    kv, kt = dec_mod.decode_body(body, nnc, lo, mu, shift, nbytes, rank,
                                 spec=spec, bs=bs, rb=rb, rebase=rebase)
    pv, pt = dec_mod.decode_body_plain(body, nnc, lo, mu, shift, nbytes, rank, spec,
                                       bs=bs, rb=rb, rebase=rebase)
    where = f"decode {spec.name} nb={nb} bs={bs} lo={lo} rb={rb} rebase={rebase}"
    check(same_bits(kv, pv), f"{where}: values differ")
    MAX_ERR["decode_body"] = max(MAX_ERR["decode_body"], max_abs_diff(kv, pv))
    check(int(kt) == int(pt), f"{where}: mid_total {int(kt)} != {int(pt)}")
    return kv, int(kt)


def kernel_vs_plain(x, e, spec, bs, *, ranges=(), expect_all_L0=False):
    """Encode x (flat, on the card) both ways, assemble the body, decode it
    both ways (full, plus block ranges with and without rebase)."""
    import torch
    from repro_torch.core.codec import device, plan, transform

    p, xt = plan.make_plan(x, e, block_size=bs, device="cuda")
    xb = plan.to_blocks(xt, p)
    enc = transform.BlockEncoding(*encode_both(xb, p.error_bound, spec))
    if expect_all_L0:
        check(not bool(enc.L.any()), f"{spec.name}: the all-L=0 fixture has L > 0")
    body, nnc, nmid = device._assemble_body(spec, enc)
    nb = p.nblocks
    vals, mid_total = decode_both(body, nnc, 0, nb, False, spec, nb, bs)
    check(mid_total == nmid, f"{spec.name}: decoded mid_total {mid_total} != {nmid}")
    y = vals.reshape(-1)[: p.n]
    fin = torch.isfinite(xt)
    err = max_abs_diff(y[fin], xt[fin])
    check(err <= p.error_bound, f"{spec.name} bs={bs}: max error {err} > {p.error_bound}")
    inf = xt.isinf()
    check(same_bits(y.isnan(), xt.isnan()) and bool((y[inf] == xt[inf]).all()),
          f"{spec.name} bs={bs}: NaN/inf not kept")
    if ranges:
        counts = (enc.nbytes[:, None].to(torch.int64) - enc.L.to(torch.int64)).clamp(min=0).sum(1)
        starts = torch.cumsum(counts, 0) - counts
        mid_off = body.numel() - nmid
        for lo, rb in ranges:
            sub, _ = decode_both(body, nnc, lo, rb, False, spec, nb, bs)
            check(same_bits(sub, vals[lo:lo + rb]), f"{spec.name}: range [{lo}, {lo + rb})")
            a = int(starts[lo])
            b = int(starts[lo + rb]) if lo + rb < nb else nmid
            rbody = torch.cat([body[:mid_off], body[mid_off + a: mid_off + b]])
            sub, _ = decode_both(rbody, nnc, lo, rb, True, spec, nb, bs)
            check(same_bits(sub, vals[lo:lo + rb]),
                  f"{spec.name}: rebased range [{lo}, {lo + rb})")
    return p, body


def phase_kernels(gen):
    import torch
    from repro_torch.kernels import specs

    for spec in specs.SPECS:
        t0 = time.perf_counter()
        e = 1e-3 if spec.itemsize >= 4 else 1e-2
        nb_frame = FRAME_BYTES // (spec.itemsize * 128)
        x = walk(nb_frame * 128, spec.dtype, gen)
        kernel_vs_plain(x, e, spec, 128,
                        ranges=((0, 1), (nb_frame // 3, nb_frame // 8), (nb_frame - 5, 5)))
        kernel_vs_plain(walk(4096, spec.dtype, gen), e, spec, 1, ranges=((17, 300),))
        kernel_vs_plain(walk(100 * 1000 + 37, spec.dtype, gen), e, spec, 100,
                        ranges=((999, 2), (3, 40)))
        kernel_vs_plain(walk(4096 * 64, spec.dtype, gen, scale=0.1), e, spec, 4096,
                        ranges=((7, 9),))
        kernel_vs_plain(torch.full((128 * 300 + 5,), 2.5, dtype=spec.dtype, device="cuda"),
                        1e-3, spec, 128)
        alt = torch.linspace(1.0, 2.0, 1 << 16, dtype=torch.float64, device="cuda")
        alt[1::2] *= -1.0
        kernel_vs_plain(alt.to(spec.dtype), 1e-3, spec, 128, expect_all_L0=True)
        tiny = float(torch.finfo(spec.dtype).tiny)          # verbatim blocks
        kernel_vs_plain(walk(128 * 200, spec.dtype, gen, scale=1.0), tiny, spec, 128)
        odd = walk(128 * 200, spec.dtype, gen)               # NaN and inf blocks
        odd[::997] = float("nan")
        odd[5::1999] = float("inf")
        odd[7::2999] = -float("inf")
        kernel_vs_plain(odd, e, spec, 128)
        torch.cuda.synchronize()
        log(f"kernels vs plain {spec.name}: bit-identical at frame nb={nb_frame} bs=128 "
            f"and edge shapes ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 3: golden digests through the kernel path
# ---------------------------------------------------------------------------

def phase_golden():
    import numpy as np
    from repro_torch.core.codec import Bound, SZxCodec

    rng = np.random.default_rng(42)
    walk32 = np.cumsum(rng.standard_normal(7777)).astype(np.float32)
    spiky = rng.standard_normal(3001).astype(np.float32)
    spiky[::97] *= 1e4
    cases = {
        "walk_bs64_rel1e-3": SZxCodec(block_size=64).compress(walk32, Bound.rel(1e-3)),
        "const_bs128": SZxCodec().compress(np.full(1000, 7.5, np.float32), 1e-3),
        "spiky_bs32_abs1e-5": SZxCodec(block_size=32).compress(spiky, 1e-5),
    }
    for name, buf in cases.items():
        digest = hashlib.sha256(buf).hexdigest()
        check(digest == GOLDEN_SHA256[name], f"golden {name}: {digest}")
    log(f"golden digests through the kernels: {len(cases)}/{len(cases)} match")


# ---------------------------------------------------------------------------
# phase 4: the main path at a size users run
# ---------------------------------------------------------------------------

def make_field(edge: int, seed: int):
    """Smooth multi-scale float32 field on the card plus small noise."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ax = torch.linspace(0.0, 1.0, edge, device="cuda", dtype=torch.float32)
    field = torch.zeros((edge, edge, edge), device="cuda", dtype=torch.float32)
    for k in range(6):
        f = (2.0 ** k) * (1.0 + torch.rand(3, device="cuda", generator=gen))
        ph = 6.283185 * torch.rand(3, device="cuda", generator=gen)
        amp = 0.6 ** k
        sx = torch.sin(6.283185 * f[0] * ax + ph[0])[:, None, None]
        sy = torch.sin(6.283185 * f[1] * ax + ph[1])[None, :, None]
        sz = torch.sin(6.283185 * f[2] * ax + ph[2])[None, None, :]
        field += amp * sx * sy * sz
    field += 1e-4 * torch.randn(field.shape, device="cuda", generator=gen)
    return field


def plain_stream(chunk, e, bs=128) -> bytes:
    """The same v2 stream through the plain versions on the card."""
    from repro_torch.core.codec import device, plan, transform
    from repro_torch.kernels import ref, specs

    p, xt = plan.make_plan(chunk, e, block_size=bs, device="cuda")
    enc = transform.BlockEncoding(*ref.encode_ref(
        plan.to_blocks(xt, p), p.error_bound, p.dtype, specs.exact_exponent_of(p.error_bound)
    ))
    body, nnc, nmid = device._assemble_body(p.dtype, enc)
    return device.to_stream(device.DeviceEncoding.make(
        "szx-v2", {"body": body}, plan=p, nnc=nnc, nmid=nmid))


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_main(args):
    import torch
    from repro_torch.core.codec import Bound, SZxCodec, container, plan

    x = make_field(args.edge, args.seed)
    flat = x.reshape(-1)
    raw = flat.numel() * 4
    codec = SZxCodec()
    bound = Bound.rel(1e-3)
    e = plan.resolve_error_bound(flat, bound)
    torch.cuda.reset_peak_memory_stats()
    # monolithic, twice: the first call also pays allocator warm-up
    buf, t_c1 = timed(lambda: codec.compress(x, bound))
    buf, t_c = timed(lambda: codec.compress(x, bound))
    y, t_d1 = timed(lambda: codec.decompress(buf))
    y, t_d = timed(lambda: codec.decompress(buf))
    err = max_abs_diff(y, flat)
    check(y.shape == flat.shape and y.dtype == flat.dtype, "monolithic shape/dtype")
    check(err <= e, f"monolithic max error {err} > e={e}")
    peak = torch.cuda.max_memory_allocated()
    log(f"main f32 {args.edge}^3 ({raw / 2**20:.0f} MiB) monolithic rel 1e-3 (e={e:.6g}): "
        f"CR {raw / len(buf):.4f}, compress {raw / t_c / 1e9:.3f} GB/s "
        f"(first call {raw / t_c1 / 1e9:.3f}), decompress {raw / t_d / 1e9:.3f} GB/s "
        f"(first call {raw / t_d1 / 1e9:.3f}), max|x-x'| {err:.6g}, "
        f"peak device memory {peak / 2**30:.2f} GiB")
    # block range of the monolithic stream
    nb = (flat.numel() + 127) // 128
    lo, hi = nb // 3, min(nb, nb // 3 + 4099)
    part = codec.decompress_range(buf, lo, hi)
    check(same_bits(part, y[lo * 128: hi * 128]), "decompress_range != slice of decompress")
    del y
    # chunked: dump with the index footer, load whole, load a selection
    torch.cuda.reset_peak_memory_stats()
    sink = io.BytesIO()
    written, t_dump = timed(lambda: codec.dump_chunked(x, sink, bound, chunk_bytes=FRAME_BYTES))
    stream = sink.getvalue()
    check(written == len(stream), "dump_chunked byte count")
    y, t_load = timed(lambda: codec.load_chunked(io.BytesIO(stream), n=flat.numel()))
    err_c = max_abs_diff(y, flat)
    check(err_c <= e, f"chunked max error {err_c} > e={e}")
    per = plan.chunk_elements(128, FRAME_BYTES, 4)
    nframes = -(-flat.numel() // per)
    sel = sorted({min(1, nframes - 1), nframes - 1})
    got = codec.load_chunked(io.BytesIO(stream), select=sel)
    want = torch.cat([y[i * per:(i + 1) * per] for i in sel])
    check(same_bits(got, want), "load_chunked(select=) != slices of load_chunked(n=)")
    first = next(container.iter_frames(io.BytesIO(stream)))
    check(first == plain_stream(flat[:per], e), "frame 0 differs from the plain route's bytes")
    log(f"main f32 chunked ({nframes} frames of {FRAME_BYTES >> 20} MiB, v3 index): "
        f"CR {raw / len(stream):.4f}, dump {raw / t_dump / 1e9:.3f} GB/s, "
        f"load {raw / t_load / 1e9:.3f} GB/s, max|x-x'| {err_c:.6g}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"select={sel} and frame-0 plain-route bytes match")
    del y, got, want
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    for dt in (torch.float64, torch.float16, torch.bfloat16):
        n = FRAME_BYTES // (torch.finfo(dt).bits // 8)
        xd = walk(n, dt, gen, scale=0.001)
        frames = list(codec.compress_chunked(xd, Bound.rel(1e-3), chunk_bytes=FRAME_BYTES // 4))
        yd = codec.decompress_chunked(frames, n=n)
        ed = plan.resolve_error_bound(xd, Bound.rel(1e-3))
        errd = max_abs_diff(yd, xd)
        check(errd <= ed, f"{dt} chunked max error {errd} > e={ed}")
        cr = n * xd.element_size() / sum(len(f) for f in frames)
        log(f"main {str(dt).removeprefix('torch.')} chunked round trip (64 MiB, "
            f"{len(frames)} frames): CR {cr:.4f}, max|x-x'| {errd:.6g} <= e={ed:.6g}")
    return x


# ---------------------------------------------------------------------------
# phase 5: per-kernel time at the frame shape
# ---------------------------------------------------------------------------

def phase_timing(field, reps: int):
    import numpy as np
    import torch
    from repro_torch.core.codec import container, device, plan
    from repro_torch.kernels import decode as dec_mod, encode as enc_mod, ref, specs

    spec = specs.F32
    per = FRAME_BYTES // 4
    chunk = field.reshape(-1)[:per]
    p, xt = plan.make_plan(chunk, plan.Bound.rel(1e-3), device="cuda")
    xb = plan.to_blocks(xt, p)
    e, p_e = p.error_bound, specs.exact_exponent_of(p.error_bound)
    nb, bs, W = p.nblocks, p.block_size, spec.itemsize
    enc_ms = cuda_ms(lambda: enc_mod.encode(xb, e, p_e, spec=spec), reps)
    enc_plain_ms = cuda_ms(lambda: enc_mod.encode_plain(xb, e, spec, p_e), max(reps // 10, 3))
    enc_bytes = nb * bs * W + nb * W + nb + 12 * nb + nb * W * bs + nb * bs

    stream = device.encode_to_stream(xb, p)
    hsize = container.HEADER.size
    body = device.to_device(np.frombuffer(stream, np.uint8, offset=hsize), "cuda")
    nnc = container.HEADER.unpack_from(stream, 0)[7]
    _c, mu, shift, nbytes, rank, _s = ref.parse_body_ref(body, nnc, spec, nb)
    args = (body, nnc, 0, mu, shift, nbytes, rank)
    dec_ms = cuda_ms(lambda: dec_mod.decode_body(*args, spec=spec, bs=bs, rb=nb), reps)
    dec_plain_ms = cuda_ms(
        lambda: dec_mod.decode_body_plain(*args, spec, bs=bs, rb=nb), max(reps // 10, 3))
    nbm = (nb + 7) // 8
    needed_body = body.numel() - (nbm + W * nb + nnc)      # L codes + mid bytes
    dec_bytes = needed_body + nb * (W + 12) + nb * bs * W + 8
    rows = []
    for name, ms, pms, nbytes_moved in (("encode", enc_ms, enc_plain_ms, enc_bytes),
                                        ("decode_body", dec_ms, dec_plain_ms, dec_bytes)):
        bound_ms = nbytes_moved / HBM_BYTES_PER_S * 1e3
        rows.append((name, ms, pms, bound_ms))
        log(f"time {name} f32 frame nb={nb} bs={bs}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes_moved / 1e6:.1f} MB at 3.35 TB/s, "
            f"{bound_ms / ms * 100:.1f}% of the bound)")
    return rows


# ---------------------------------------------------------------------------
# phase 6: where one frame's time goes
# ---------------------------------------------------------------------------

def phase_breakdown(field, reps: int = 5) -> None:
    """Host-clock time of each stage of compress and decompress for one
    64 MiB f32 frame (synchronized around every stage; median of reps)."""
    import statistics

    import numpy as np
    import torch
    from repro_torch.core.codec import container, device, plan, transform
    from repro_torch.kernels import decode as dec_mod, ops, ref, specs

    spec = specs.F32
    chunk = field.reshape(-1)[: FRAME_BYTES // 4]
    e = plan.resolve_error_bound(field.reshape(-1), plan.Bound.rel(1e-3))
    p_e = specs.exact_exponent_of(e)
    times: dict[str, list[float]] = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return res

    for _ in range(reps):
        p, xt = stage("c.plan", lambda: plan.make_plan(chunk, e, device="cuda"))
        xb = plan.to_blocks(xt, p)
        enc = stage("c.encode kernel", lambda: transform.BlockEncoding(
            *ops.encode_staged(xb, e, p_e, spec=spec)))
        body, nnc, nmid = stage("c.assemble body", lambda: device._assemble_body(spec, enc))
        host = stage("c.copy to host", lambda: device.to_host(body))
        stream = stage("c.header + bytes", lambda: b"".join((container.HEADER.pack(
            container.MAGIC, container.VERSION, 0, 128, p.n, e, p.nblocks, nnc, nmid),
            host.numpy())))
        stage("c.total SZxCodec.compress", lambda: device.encode_to_stream(xb, p))
        raw = np.frombuffer(stream, np.uint8, offset=container.HEADER.size)
        dbody = stage("d.copy to device", lambda: device.to_device(raw, "cuda"))
        parsed = stage("d.parse body", lambda: ref.parse_body_ref(dbody, nnc, spec, p.nblocks))
        vals, total = stage("d.decode kernel", lambda: dec_mod.decode_body(
            dbody, nnc, 0, *parsed[1:5], spec=spec, bs=128, rb=p.nblocks))
        stage("d.measured readback", lambda: device.to_host(
            torch.stack([parsed[5], parsed[3].max().to(torch.int64), total])))
        stage("d.total SZxCodec.decompress", lambda: device.decode_stream(stream, device="cuda"))
    med = {k: statistics.median(v) for k, v in times.items()}
    for side, label in (("c.", "compress"), ("d.", "decompress")):
        total = next(v for k, v in med.items() if k.startswith(side + "total"))
        parts = ", ".join(f"{k[2:]} {v:.3f} ms ({100 * v / total:.0f}%)"
                          for k, v in med.items() if k.startswith(side) and "total" not in k)
        log(f"breakdown {label} of one f32 64 MiB frame (median of {reps}): "
            f"total {total:.3f} ms = {FRAME_BYTES / total / 1e6:.3f} GB/s; {parts}")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--edge", type=int, default=512,
                    help="edge of the cubic f32 field on the main path (512 = 512 MiB)")
    ap.add_argument("--reps", type=int, default=50, help="timed launches per kernel")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    nvcc_version = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}), {nvcc_version}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'} "
        f"(wall {time.perf_counter() - t0:.1f} s, nvcc {' '.join(_build.NVCC_FLAGS)})")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_kernels(gen)
    phase_golden()

    ops.reset_launch_counts()
    field = phase_main(args)
    launches = ops.launch_counts()
    log(f"main-path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    rows = phase_timing(field, args.reps)
    phase_breakdown(field)
    sources = {"encode": ("src/repro_torch/csrc/encode.cu", "src/repro/kernels/encode.py:57"),
               "decode_body": ("src/repro_torch/csrc/decode.cu", "src/repro/kernels/decode.py:108")}
    kernels = []
    for name, ms, pms, bound_ms in rows:
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": MAX_ERR[name],
            "ms": ms, "plain_ms": pms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
