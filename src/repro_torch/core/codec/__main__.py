"""File CLI for the SZx codec on torch (the JAX package's CLI, same streams).

    python -m repro_torch.core.codec compress   IN.bin OUT.szx --dtype float32 \
        --bound rel:1e-3
    python -m repro_torch.core.codec decompress IN.szx OUT.bin
    python -m repro_torch.core.codec info       IN.szx [--json] [--stats]

``--bound`` takes the unified spelling (``1e-3`` = abs, ``abs:1e-3``,
``rel:1e-4``); the legacy ``--error-bound``/``--mode`` pair still works.
``--device`` picks where the codec runs (default ``cuda``); ``--stage``
adds the negotiated second stage to the compressed frames.

``compress`` reads a raw binary array (``--dtype`` elements), writes a
chunked container-v3 stream (self-delimiting frames + seekable index
footer; ``--no-index`` emits a footer-less v2 frame sequence).
``decompress`` restores the raw binary; ``info`` prints the stream header
and index without decoding, and with ``--stats`` each frame's stream stats
(``repro_torch.obs.stream_stats``: elements, CR, const-block fraction,
stage, mid bytes) and its measured decode time.  Exit code is non-zero on
any error.
"""
from __future__ import annotations

import argparse
import struct
import sys

import numpy as np
import torch


def _read_raw(path: str, spec) -> torch.Tensor:
    """Raw little-endian file -> CPU tensor of the spec's dtype (read as
    same-width integers, so bfloat16 needs no numpy extension dtype)."""
    words = np.fromfile(path, dtype=np.dtype(f"<i{spec.itemsize}"))
    return torch.from_numpy(words).view(spec.dtype)


def resolve_cli_bound(args):
    """--bound SPEC, or the legacy --error-bound/--mode pair -> Bound."""
    from repro_torch.core.codec.plan import Bound

    if getattr(args, "bound", None) is not None:
        if args.error_bound is not None or args.mode is not None:
            raise ValueError("pass --bound OR --error-bound/--mode, not both")
        return Bound.parse(args.bound)
    if args.error_bound is None:
        raise ValueError("an error bound is required (--bound SPEC)")
    return Bound(args.error_bound, args.mode or "abs")


def _cmd_compress(args) -> int:
    from repro_torch.core.codec import SZxCodec, plan

    spec = plan.spec_for(args.dtype)
    data = _read_raw(args.input, spec)
    bound = resolve_cli_bound(args)
    codec = SZxCodec(block_size=args.block_size, device=args.device,
                     workers=args.workers, stage=args.stage)
    with open(args.output, "wb") as f:
        written = codec.dump_chunked(
            data, f, bound,
            chunk_bytes=args.chunk_bytes, index=not args.no_index,
        )
    raw = data.numel() * spec.itemsize
    print(
        f"{args.input}: {raw} -> {written} bytes "
        f"(CR {raw / max(written, 1):.2f}, n={data.numel()} {spec.name}, "
        f"{bound})"
    )
    return 0


def _cmd_decompress(args) -> int:
    from repro_torch.core.codec import SZxCodec, device, plan

    codec = SZxCodec(device=args.device, workers=args.workers)
    with open(args.input, "rb") as f:
        arr = codec.load_chunked(f)
    spec = plan.spec_for(arr.dtype)
    device.to_host(arr).view(spec.word_dtype).numpy().tofile(args.output)
    print(f"{args.input}: restored {arr.numel()} {spec.name} -> {args.output}")
    return 0


def _scan_frames(f, container, device):
    """Sequential frame walk for footer-less v2 streams, through the
    container's validating iterator: (nframes, nraw, total elements, dtype
    code, e)."""
    nframes = nraw = 0
    total_n = 0
    dtype_code = None
    e = None
    for payload, flags in container.iter_frames(f, with_flags=True, device=device):
        nframes += 1
        if flags & container.FLAG_RAW:
            nraw += 1                          # raw pack: no v2 header inside
        else:
            dtype_code, n, e = container.peek_stream_meta(payload)
            total_n += n
    return nframes, nraw, total_n, dtype_code, e


def _iter_whole_frames(f, container):
    """Yield (frame bytes incl. header, flags) sequentially until LAST."""
    while True:
        head = f.read(container.FRAME_HEADER.size)
        if len(head) < container.FRAME_HEADER.size:
            return
        magic, _v, flags, _seq, ln = container.FRAME_HEADER.unpack_from(head, 0)
        if magic != container.FRAME_MAGIC:
            return
        body = f.read(ln)
        if len(body) != ln:
            raise ValueError("truncated SZx frame")
        yield head + body, flags
        if flags & container.FLAG_LAST:
            return


def _frame_stats_rows(path: str, container, device) -> list[dict]:
    """Per-frame ground-truth records (obs.stream_stats) plus a measured
    decode time per non-raw frame (host clock; the decode ends when its
    measured scalars are back on the host)."""
    import time

    from repro_torch.core.codec import SZxCodec
    from repro_torch.obs import stream_stats

    codec = SZxCodec(device=device)
    rows = []
    with open(path, "rb") as f:
        for frame, flags in _iter_whole_frames(f, container):
            rec = stream_stats.frame_stats(frame)
            if not rec.get("raw"):
                payload, _ = container.destage_frame_payload(
                    frame[container.FRAME_HEADER.size:], flags, device=device)
                t0 = time.perf_counter()
                codec.decompress(payload)
                rec["decode_ms"] = (time.perf_counter() - t0) * 1e3
            rows.append(rec)
    return rows


def _print_stats_table(rows: list[dict]) -> None:
    print(f"{'seq':>5} {'elements':>10} {'frame_B':>10} {'CR':>7} "
          f"{'const%':>7} {'stage':>15} {'mid raw->staged':>18} {'dec_ms':>8}")
    for r in rows:
        if r.get("raw"):
            print(f"{r['seq']:>5} {'-':>10} {r['frame_bytes']:>10} "
                  f"{'-':>7} {'-':>7} {'raw-pack':>15} {'-':>18} {'-':>8}")
            continue
        mid = f"{r['raw_mid_bytes']}->{r['staged_mid_bytes']}"
        print(f"{r['seq']:>5} {r['elements']:>10} {r['frame_bytes']:>10} "
              f"{r['ratio']:>7.2f} {100 * r['const_fraction']:>6.1f}% "
              f"{r['stage_name']:>15} {mid:>18} {r['decode_ms']:>8.2f}")


def _cmd_info(args) -> int:
    import json

    from repro_torch.core.codec import container, plan

    with open(args.input, "rb") as f:
        # corrupt footers degrade to the sequential scan with a warning
        idx = container.read_index_footer_safe(f)
        if idx is None:
            f.seek(0)
            nframes, nraw, total_n, dtype_code, e = _scan_frames(f, container, args.device)
        else:
            # answer from the index: read at most one frame for dtype/e
            nframes = len(idx["frames"])
            nraw = 0
            total_n = idx.get("n", 0)
            dtype_code = idx.get("dtype")
            e = None
            if idx["frames"]:
                off, length = idx["frames"][0][:2]
                payload, _flags = container.read_frame_at(f, off, length, 0,
                                                          device=args.device)
                dtype_code, _n, e = container.peek_stream_meta(payload)
    dtype = plan.spec_for_code(dtype_code).name if dtype_code is not None else None
    stats_rows = _frame_stats_rows(args.input, container, args.device) if args.stats else None
    if args.json:
        info = {
            "frames": nframes,
            "raw_frames": nraw,
            "n": total_n,
            "dtype": dtype,
            "e": e,
            "index": ("v" + str(idx["v"])) if idx else None,
            "kind": idx.get("kind") if idx else None,
            "frame_ranges": idx["frames"] if idx else None,
        }
        if stats_rows is not None:
            info["frames_stats"] = stats_rows
        print(json.dumps(info, indent=1))
        return 0
    bound = f"{e:g}" if e is not None else "n/a"
    print(f"frames: {nframes} ({nraw} raw), elements: {total_n}, "
          f"dtype: {dtype or 'n/a'}, e: {bound}")
    print(f"index footer: {'v' + str(idx['v']) if idx else 'absent (v2 stream)'}")
    if idx:
        print(f"indexed frames: {len(idx['frames'])}, kind: {idx.get('kind')}")
    if stats_rows is not None:
        _print_stats_table(stats_rows)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.codec", description=__doc__.splitlines()[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="raw binary -> chunked SZx stream")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--bound", default=None, metavar="SPEC",
                   help="error bound: '1e-3' (abs), 'abs:1e-3', 'rel:1e-4'")
    c.add_argument("--error-bound", type=float, default=None,
                   help="legacy: ABS bound, or REL factor with --mode rel")
    c.add_argument("--mode", choices=("abs", "rel"), default=None)
    c.add_argument("--dtype", default="float32",
                   help="element dtype of the raw input (float32/float64/"
                        "float16/bfloat16)")
    c.add_argument("--block-size", type=int, default=128)
    c.add_argument("--chunk-bytes", type=int, default=64 << 20)
    c.add_argument("--workers", type=int, default=1)
    c.add_argument("--device", default="cuda")
    c.add_argument("--no-index", action="store_true",
                   help="omit the container-v3 index footer")
    c.add_argument("--stage", default=None,
                   choices=("bitshuffle-rle", "bitshuffle-zstd", "deflate"),
                   help="negotiated lossless second stage over the mid-byte "
                        "section (per-frame; skipped when it would not shrink)")
    c.set_defaults(fn=_cmd_compress)

    d = sub.add_parser("decompress", help="SZx stream -> raw binary")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--workers", type=int, default=1)
    d.add_argument("--device", default="cuda")
    d.set_defaults(fn=_cmd_decompress)

    i = sub.add_parser("info", help="print stream header/index summary")
    i.add_argument("input")
    i.add_argument("--json", action="store_true",
                   help="machine-readable summary incl. per-frame byte ranges")
    i.add_argument("--stats", action="store_true",
                   help="per-frame stream stats (elements, CR, const-block "
                        "fraction, stage, mid bytes, measured decode time)")
    i.add_argument("--device", default="cuda",
                   help="where staged frames are destaged (and, with --stats, "
                        "decoded) while walking them")
    i.set_defaults(fn=_cmd_info)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, TypeError, RuntimeError, struct.error) as err:
        print(f"error: {err}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
