"""Quickstart (PyTorch port): SZx error-bounded compression of a scientific
field on the card.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py`` over ``repro_torch.api``: the
one-shot compression of a field at three relative bounds with the unified
Bound spec, native multi-dtype streams and bounded-memory chunked
compression through ``SZxCodec``, and the block-addressable array store
(``ArrayStore``): lazy ROI reads and compressed-domain queries.  Everything
runs on the chosen device; the streams are byte-identical to the JAX
package's, so the compression ratios are the reference's.  Without
``--device`` it runs on the card, and fails without one.
"""
import argparse
import io
import time

import torch

from repro_torch.api import ArrayStore, Bound, SZxCodec
from repro_torch.core import metrics
from repro_torch.core.codec.device import resolve_device
from repro_torch.data import scidata


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card (raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "examples/quickstart_torch.py")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    codec = SZxCodec(device=dev)
    name, xn = next(iter(scidata.fields("Miranda")))
    x = torch.from_numpy(xn).to(dev)
    nbytes = x.numel() * x.element_size()
    print(f"field {name}: shape={tuple(x.shape)} ({nbytes/1e6:.1f} MB) on {dev}")

    for rel in (1e-2, 1e-3, 1e-4):
        sync()
        t0 = time.perf_counter()
        buf, stats = codec.compress_with_stats(x, Bound.rel(rel))
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        y = codec.decompress(buf).reshape(x.shape)
        sync()
        t_d = time.perf_counter() - t0
        err = float((x - y).abs().max())
        print(
            f"REL={rel:g}: CR={stats.ratio:6.2f}  "
            f"comp={nbytes/1e6/t_c:5.0f} MB/s  decomp={nbytes/1e6/t_d:5.0f} MB/s  "
            f"PSNR={metrics.psnr(x, y):5.1f} dB  max|err|/e={err/stats.error_bound:.3f}"
        )
        assert err <= stats.error_bound, "error bound violated!"
    print("error bound strictly respected at every setting")

    # --- layered codec: multi-dtype + chunked streaming ------------------
    for dtype in (torch.float64, torch.float16):
        xd = x.to(dtype)
        buf = codec.compress(xd, Bound.rel(1e-2))
        y = codec.decompress(buf)
        print(
            f"native {str(dtype).split('.')[-1]}: "
            f"CR={xd.numel() * xd.element_size()/len(buf):5.2f}  decoded dtype={y.dtype}"
        )
    sink = io.BytesIO()
    written = codec.dump_chunked(x, sink, Bound.rel(1e-3), chunk_bytes=1 << 20)
    sink.seek(0)
    y = codec.load_chunked(sink).reshape(x.shape)
    e = 1e-3 * float(x.max() - x.min())
    worst = float((x - y).abs().max())
    print(
        f"chunked: {written/1e6:.1f} MB in 1 MB self-delimiting frames, "
        f"max|err|/e={worst / e:.3f}"
    )
    assert worst <= e, "chunked error bound violated!"

    # --- array store: lazy ROI reads + compressed-domain queries ----------
    store = io.BytesIO()
    ArrayStore.save(store, x, Bound.rel(1e-3), device=dev)
    ca = ArrayStore.open(store, device=dev)
    sync()
    t0 = time.perf_counter()
    roi = ca[x.shape[0] // 2, : x.shape[1] // 2]       # one half-plane slice
    sync()
    t_roi = time.perf_counter() - t0
    assert float((roi - x[x.shape[0] // 2, : x.shape[1] // 2]).abs().max()) <= e
    stats = ca.stats()                                  # exact, from headers
    hdr = ca.stats(header_only=True)                    # intervals, no planes
    mean = float(x.to(torch.float64).mean())
    print(
        f"store: {ca.nchunks} chunks of {ca.chunk_shape}, "
        f"ROI {roi.numel() * roi.element_size()/1e3:.0f} kB "
        f"in {t_roi*1e3:.1f} ms; query mean={stats.mean[0]:.4f} "
        f"(torch {mean:.4f}), "
        f"{hdr.const_blocks}/{hdr.nblocks} blocks answered header-only"
    )
    assert abs(stats.mean[0] - mean) <= e


if __name__ == "__main__":
    main()
