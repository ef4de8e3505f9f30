"""File CLI for the array store on torch (the JAX package's CLI, same files).

    python -m repro_torch.store create IN.bin OUT.szs --shape 256,256,256 \
        --dtype float32 --bound rel:1e-3 [--stage deflate]
    python -m repro_torch.store info   STORE.szs [--json]
    python -m repro_torch.store read   STORE.szs OUT.bin --roi "0:16,:,3"
    python -m repro_torch.store query  STORE.szs [--roi ...] [--header-only] [--json]
    python -m repro_torch.store serve  STORE.szs [--port 8117] [--fused-range]

``create`` writes a chunk-grid store from a raw little-endian binary array;
``read`` decodes only the requested ROI; ``query`` runs the
compressed-domain stats scan; ``serve`` starts the HTTP slice/query service
(:mod:`repro_torch.serve.store_service`).  ``--device`` picks where the
codec runs (default ``cuda``).  Exit code is non-zero on any error.
"""
from __future__ import annotations

import argparse
import json
import struct
import sys
from pathlib import Path

import torch

from repro_torch.store.grid import parse_roi


def _shape(text: str) -> tuple[int, ...]:
    return tuple(int(v) for v in text.split(",") if v.strip())


def _cmd_create(args) -> int:
    from repro_torch.core.codec.__main__ import resolve_cli_bound
    from repro_torch.kernels.specs import spec_for
    from repro_torch.store import ArrayStore

    spec = spec_for(args.dtype)
    data = torch.frombuffer(bytearray(Path(args.input).read_bytes()), dtype=spec.dtype)
    data = data.reshape(_shape(args.shape))
    kw = dict(
        chunk_shape=_shape(args.chunk_shape) if args.chunk_shape else None,
        block_size=args.block_size, device=args.device, workers=args.workers,
        stage=args.stage,
    )
    if args.shards:
        man = ArrayStore.save_sharded(
            args.output, data, resolve_cli_bound(args), nshards=args.shards, **kw,
        )
        frames = [fr for sh in man["shards"] for fr in sh["frames"]]
        chunk_shape, e = man["chunk_shape"], man["e"]
        where = f"{len(man['shards'])} shard files + manifest"
    else:
        idx = ArrayStore.save(args.output, data, resolve_cli_bound(args), **kw)
        frames, chunk_shape, e = idx["frames"], idx["chunk_shape"], idx["e"]
        where = "1 file"
    raw = data.numel() * spec.itemsize
    stored = sum(f[1] for f in frames)
    print(
        f"{args.input}: {raw} -> {stored} bytes in "
        f"{len(frames)} chunks of {tuple(chunk_shape)} ({where}, "
        f"CR {raw / max(stored, 1):.2f}, e={e:g})"
    )
    return 0


def _cmd_info(args) -> int:
    from repro_torch.store import ArrayStore

    with ArrayStore.open(args.input, device=args.device) as ca:
        info = {
            "kind": "szx-store",
            "shape": list(ca.shape),
            "chunk_shape": list(ca.chunk_shape),
            "dtype": str(ca.dtype).removeprefix("torch."),
            "e": ca.error_bound,
            "nchunks": ca.nchunks,
            "raw_bytes": ca.nbytes,
            "stored_bytes": ca.stored_bytes,
            "cr": ca.nbytes / max(ca.stored_bytes, 1),
            "attrs": ca.attrs,
            "stage": ca.stage,
        }
    if args.json:
        print(json.dumps(info, indent=1))
    else:
        print(
            f"store {tuple(info['shape'])} {info['dtype']} in "
            f"{info['nchunks']} chunks of {tuple(info['chunk_shape'])}, "
            f"e={info['e']:g}, CR={info['cr']:.2f}"
        )
    return 0


def _cmd_read(args) -> int:
    from repro_torch.core.codec.device import to_host
    from repro_torch.kernels.specs import spec_for
    from repro_torch.store import ArrayStore

    with ArrayStore.open(args.input, device=args.device) as ca:
        out = ca[parse_roi(args.roi)]
    spec = spec_for(out.dtype)
    to_host(out.contiguous()).view(spec.word_dtype).numpy().tofile(args.output)
    print(f"{args.input}[{args.roi or '...'}]: {tuple(out.shape)} {spec.name} "
          f"({out.numel() * spec.itemsize} bytes) -> {args.output}")
    return 0


def _cmd_query(args) -> int:
    from repro_torch.core.codec.device import to_host
    from repro_torch.store import ArrayStore

    with ArrayStore.open(args.input, device=args.device) as ca:
        if args.roi:
            # ROI queries decode the (small) region and reduce it on the device
            sub = ca[parse_roi(args.roi)].to(torch.float64)
            s, mean, lo, hi = to_host(torch.stack(
                [sub.sum(), sub.mean(), sub.min(), sub.max()])).tolist()
            stats = {
                "count": int(sub.numel()), "exact": True,
                "sum": [s] * 2, "mean": [mean] * 2, "min": [lo] * 2, "max": [hi] * 2,
            }
        else:
            stats = ca.stats(header_only=args.header_only).to_dict()
    if args.json:
        print(json.dumps(stats, indent=1))
    elif stats["exact"]:
        print(
            f"count={stats['count']} mean={stats['mean'][0]:.8g} "
            f"min={stats['min'][0]:.8g} max={stats['max'][0]:.8g} "
            f"sum={stats['sum'][0]:.8g}"
        )
    else:
        print(
            f"count={stats['count']} "
            f"mean=[{stats['mean'][0]:.8g}, {stats['mean'][1]:.8g}] "
            f"min=[{stats['min'][0]:.8g}, {stats['min'][1]:.8g}] "
            f"max=[{stats['max'][0]:.8g}, {stats['max'][1]:.8g}]"
        )
    return 0


def _cmd_serve(args) -> int:
    from repro_torch.serve.store_service import serve_store

    serve_store(args.input, host=args.host, port=args.port, device=args.device,
                fused_range=args.fused_range)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.store", description=__doc__.splitlines()[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create", help="raw binary -> chunk-grid store")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--shape", required=True, help="comma-separated dims")
    c.add_argument("--bound", default=None, metavar="SPEC",
                   help="error bound: '1e-3' (abs), 'abs:1e-3', 'rel:1e-4'")
    c.add_argument("--error-bound", type=float, default=None,
                   help="legacy: ABS bound, or REL factor with --mode rel")
    c.add_argument("--mode", choices=("abs", "rel"), default=None)
    c.add_argument("--dtype", default="float32",
                   help="element dtype of the raw input (float32/float64/"
                        "float16/bfloat16)")
    c.add_argument("--chunk-shape", default=None, help="comma-separated dims")
    c.add_argument("--shards", type=int, default=0,
                   help="write N shard files + a JSON manifest (OUTPUT is "
                        "the manifest path) instead of one store file")
    c.add_argument("--block-size", type=int, default=128)
    c.add_argument("--workers", type=int, default=1)
    c.add_argument("--stage", default=None,
                   choices=("bitshuffle-rle", "bitshuffle-zstd", "deflate"),
                   help="negotiated lossless second stage over the mid-byte "
                        "section (per-chunk; skipped when it would not shrink)")
    c.set_defaults(fn=_cmd_create)

    i = sub.add_parser("info", help="print store geometry")
    i.add_argument("input")
    i.add_argument("--json", action="store_true")
    i.set_defaults(fn=_cmd_info)

    r = sub.add_parser("read", help="ROI -> raw binary")
    r.add_argument("input")
    r.add_argument("output")
    r.add_argument("--roi", default=None, help='e.g. "0:16,:,3"')
    r.set_defaults(fn=_cmd_read)

    q = sub.add_parser("query", help="compressed-domain stats")
    q.add_argument("input")
    q.add_argument("--roi", default=None)
    q.add_argument("--header-only", action="store_true",
                   help="interval stats, never reading plane bytes")
    q.add_argument("--json", action="store_true")
    q.set_defaults(fn=_cmd_query)

    s = sub.add_parser("serve", help="HTTP slice/query service")
    s.add_argument("input")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8117)
    s.add_argument("--fused-range", action="store_true",
                   help="decode ROIs by the fused range decode instead of the host "
                        "parse and the unpack kernels")
    s.set_defaults(fn=_cmd_serve)

    for p in (c, i, r, q, s):
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, TypeError, KeyError, IndexError, RuntimeError,
            struct.error) as err:
        print(f"error: {err}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
