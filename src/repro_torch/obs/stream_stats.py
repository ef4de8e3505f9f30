"""Per-frame codec stream statistics.

Two halves:

* Pure parsers -- :func:`payload_stats` / :func:`frame_stats` compute a
  frame's ground-truth record (elements, raw/compressed bytes, CR,
  const-block fraction, L-code histogram, stage chosen, staged vs raw mid
  bytes) straight from container bytes.  They read ONLY the v2 metadata
  prefix, which the second stage keeps verbatim, so they work identically on
  stage-on and stage-off frames without destaging anything.

* Runtime recorders -- ``record_*`` helpers called from the codec hot paths
  when :func:`repro_torch.obs.enabled`.  They feed the global registry's counters/
  histograms and the bounded frame log that ``python -m
  repro_torch.core.codec info --stats`` surfaces.

Container imports are deferred into the functions: ``repro_torch.core.codec``
modules import :mod:`repro_torch.obs` at module scope, and this keeps the obs
package import-free of the codec (no cycle).  The port's streams are
byte-identical to the reference's, and so are these records.
"""
from __future__ import annotations

import numpy as np

# counts of each 2-bit field value per byte: _L2BIT_TABLE[b, c] = how many of
# byte b's four 2-bit fields equal c.  Field order inside the byte does not
# matter for counting, so this is packing-order agnostic.
_L2BIT_TABLE = None
_M01 = np.uint64(0x5555555555555555)            # low bit of every 2-bit field


def _l2bit_table() -> np.ndarray:
    global _L2BIT_TABLE
    if _L2BIT_TABLE is None:
        b = np.arange(256, dtype=np.uint16)
        fields = np.stack([(b >> s) & 0x3 for s in (0, 2, 4, 6)], axis=1)
        tbl = np.zeros((256, 4), np.int64)
        for c in range(4):
            tbl[:, c] = (fields == c).sum(axis=1)
        _L2BIT_TABLE = tbl
    return _L2BIT_TABLE


def _l2bit_hist(lbytes: np.ndarray) -> np.ndarray:
    """Exact per-code counts of the packed 2-bit fields in ``lbytes``.

    This sits on the telemetry-on compress hot path (once per frame), so it
    counts via popcount identities over a uint64 view -- for each 2-bit
    field f: popcount(f) = [f==1] + [f==2] + 2*[f==3], the high bits alone
    give c2+c3, and low&high gives c3 -- which is ~3x faster than a
    256-bin bincount.  Falls back to the byte-table bincount on numpy < 2
    (no ``bitwise_count``)."""
    if not hasattr(np, "bitwise_count"):
        hist = _l2bit_table().T @ np.bincount(lbytes, minlength=256)
        return hist
    nw = len(lbytes) // 8
    v = np.frombuffer(lbytes, np.uint64, nw)
    hi = (v >> np.uint64(1)) & _M01
    p = int(np.bitwise_count(v).sum(dtype=np.int64))      # c1 + c2 + 2*c3
    h = int(np.bitwise_count(hi).sum(dtype=np.int64))     # c2 + c3
    c3 = int(np.bitwise_count(v & hi).sum(dtype=np.int64))
    c2 = h - c3
    c1 = p - h - c3
    if len(lbytes) > nw * 8:                              # unaligned tail
        tc = _l2bit_table()[lbytes[nw * 8:]].sum(axis=0)
        c1 += int(tc[1]); c2 += int(tc[2]); c3 += int(tc[3])
    return np.array([len(lbytes) * 4 - c1 - c2 - c3, c1, c2, c3], np.int64)


def payload_stats(payload, *, l_hist: bool = True) -> dict:
    """Ground-truth stats of one v2 stream payload from its metadata prefix.

    ``payload`` may be a full stream, a staged frame payload, or just the
    metadata prefix -- only the header + L sections are touched.  The L-code
    histogram is computed with one byte-level bincount (O(prefix), no block
    decode); ``l_hist=False`` skips it (header-only cost) for recorders that
    only feed counters.
    """
    from repro_torch.core.codec import container, plan as plan_mod

    buf = bytes(payload) if not isinstance(payload, (bytes, bytearray)) \
        else payload
    magic, version, dtype_code, bs, n, e, nb, nnc, nmid = \
        container.HEADER.unpack_from(buf, 0)
    if magic != container.MAGIC:
        raise ValueError("bad SZx stream header (magic mismatch)")
    spec = plan_mod.spec_for_code(dtype_code)
    nbm = (nb + 7) // 8
    nl = (nnc * bs + 3) // 4
    off_l = container.HEADER.size + nbm + spec.itemsize * nb + nnc
    if len(buf) < off_l + nl:
        raise ValueError("truncated SZx stream (metadata prefix)")
    hist = np.zeros(4, np.int64)
    if nl and l_hist:
        lbytes = np.frombuffer(buf, np.uint8, nl, off_l)
        hist = _l2bit_hist(lbytes)
        hist[0] -= nl * 4 - nnc * bs      # 2-bit padding fields pack as 0
    raw_bytes = n * spec.itemsize
    return {
        "elements": int(n),
        "dtype": spec.name,
        "error_bound": float(e),
        "block_size": int(bs),
        "nblocks": int(nb),
        "const_blocks": int(nb - nnc),
        "const_fraction": float(nb - nnc) / nb if nb else 0.0,
        "raw_bytes": int(raw_bytes),
        "prefix_bytes": int(off_l + nl),
        "mid_bytes": int(nmid),
        "l_hist": [int(c) for c in hist],
    }


def frame_stats(frame: bytes) -> dict:
    """Ground-truth record of one self-delimiting container frame.

    Extends :func:`payload_stats` with the frame envelope: seq, stage chosen
    (from the frame-flag stage bits), staged vs raw mid bytes, frame bytes,
    and the frame-level compression ratio.  Raw (``FLAG_RAW``) frames yield a
    minimal record with ``"raw": True``.
    """
    from repro_torch.core.codec import container, stage as stage_mod

    magic, version, flags, seq, ln = container.FRAME_HEADER.unpack_from(
        frame, 0
    )
    if magic != container.FRAME_MAGIC:
        raise ValueError("bad SZx frame header (magic mismatch)")
    payload = frame[container.FRAME_HEADER.size:container.FRAME_HEADER.size
                    + ln]
    if len(payload) != ln:
        raise ValueError("truncated SZx frame")
    frame_bytes = container.FRAME_HEADER.size + ln
    if flags & container.FLAG_RAW:
        return {
            "seq": int(seq), "raw": True, "frame_bytes": int(frame_bytes),
            "payload_bytes": int(ln),
        }
    code = container.stage_of_flags(flags)
    rec = payload_stats(payload)
    staged_mid = int(ln) - rec["prefix_bytes"]
    rec.update({
        "seq": int(seq),
        "raw": False,
        "frame_bytes": int(frame_bytes),
        "payload_bytes": int(ln),
        "stage": int(code),
        "stage_name": stage_mod.name_of(code),
        "raw_mid_bytes": rec["mid_bytes"],
        "staged_mid_bytes": staged_mid if code else rec["mid_bytes"],
        "ratio": rec["raw_bytes"] / frame_bytes if frame_bytes else 0.0,
    })
    return rec


# ---------------------------------------------------------------------------
# runtime recorders (callers MUST guard with obs.enabled())
# ---------------------------------------------------------------------------

def record_compress(payload, seconds: float) -> None:
    """One SZxCodec.compress call -> counters + encode-time histogram.

    Header-only stats (no L bincount): the per-frame log, fed once per frame
    by :func:`record_frame_built`, carries the histogram."""
    from repro_torch import obs

    st = payload_stats(payload, l_hist=False)
    r = obs.REGISTRY
    r.counter("codec.compress.calls").inc()
    r.counter("codec.compress.raw_bytes").inc(st["raw_bytes"])
    r.counter("codec.compress.compressed_bytes").inc(len(payload))
    r.counter("codec.compress.const_blocks").inc(st["const_blocks"])
    r.counter("codec.compress.blocks").inc(st["nblocks"])
    r.histogram("codec.compress.seconds").observe(seconds)


def record_decompress(nbytes_out: int, seconds: float,
                      kind: str = "full") -> None:
    """One SZxCodec.decompress / decompress_range call."""
    from repro_torch import obs

    r = obs.REGISTRY
    r.counter("codec.decompress.calls", kind=kind).inc()
    r.counter("codec.decompress.raw_bytes", kind=kind).inc(nbytes_out)
    r.histogram("codec.decompress.seconds", kind=kind).observe(seconds)


def record_frame_built(payload, frame_len: int, seq: int,
                       stage_code: int) -> None:
    """One container frame built -> per-frame record in the frame log."""
    from repro_torch import obs
    from repro_torch.core.codec import container

    rec = payload_stats(payload)
    staged_mid = frame_len - container.FRAME_HEADER.size - rec["prefix_bytes"]
    rec.update({
        "seq": int(seq),
        "stage": int(stage_code),
        "frame_bytes": int(frame_len),
        "raw_mid_bytes": rec["mid_bytes"],
        "staged_mid_bytes": staged_mid if stage_code else rec["mid_bytes"],
        "ratio": rec["raw_bytes"] / frame_len if frame_len else 0.0,
    })
    r = obs.REGISTRY
    r.record_frame(rec)
    r.counter("codec.frames.built", stage=stage_code).inc()
    r.counter("codec.frames.raw_bytes").inc(rec["raw_bytes"])
    r.counter("codec.frames.frame_bytes").inc(frame_len)
