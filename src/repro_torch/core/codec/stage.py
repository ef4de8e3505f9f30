"""Negotiated lossless second stage over the mid-byte section (container v3).

SZx trades ratio for speed: after the error-bounded quantization the mid-byte
stream still carries redundancy.  This module is the ratio tier, a
*per-frame negotiated* stage recorded in the frame-flag stage bits
(``container.FLAG_STAGE_MASK``).  Only the mid-byte section is transformed:
the header, const bitmap, mu, reqlen and L sections stay raw, so the
header-only query tier and ROI block arithmetic keep working on untouched
bytes.  Staged payloads are byte-identical to the JAX package's.

Layout of a staged frame payload::

    [v2 metadata prefix]                      -- byte-identical to stage-off
    [stage table '<HI': seg_blocks | nseg]
    [u32 * nseg: byte length of each segment record]
    [record 0] ... [record nseg-1]            -- mode u8 (0 raw | 1 staged)
                                                 + segment body

Segments are fixed block ranges (``seg_blocks`` blocks), so ROI readers map a
block range to a segment range, read ONLY those records and destage them
(:func:`read_mid_range`).  Negotiation is two-level: a segment whose staged
body is not smaller stays raw (mode 0), and a frame whose staged payload is
not smaller than the raw payload stays stage-off (:func:`stage_payload`
returns ``None``), so a stage can never lose.

Stage codecs:

  1 ``bitshuffle-rle``   byteplane-major shuffle within each segment (the
                         permutation comes from the raw metadata prefix, so
                         it costs no side data) -> bit transpose of whole
                         tiles (``kernels.bitshuffle``) -> (value, run) byte
                         pair RLE.
  2 ``bitshuffle-zstd``  the same bit-transposed tiles through ``zstandard``
                         (optional; readers without it fail loudly, writers
                         refuse).
  3 ``deflate``          segment bytes in their natural (block, value,
                         byteplane) order through stdlib DEFLATE.

Where it runs.  The shuffle runs where the codec runs (``device=``: ``None``
means the card and raises without one; ``"cpu"`` runs the plain versions).
Per frame (or per ROI segment range) the mid bytes cross to the device once,
every segment's permutation is gathered there, each segment is zero-padded
to whole tiles, ONE bitshuffle launch covers all of the frame's tiles, and
the result comes back once.  RLE, zstd and deflate run on the host.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from repro_torch.core.codec import container
from repro_torch import obs
from repro_torch.core.codec.device import resolve_device, to_device, to_host
from repro_torch.kernels import ops
from repro_torch.kernels.specs import tile_bytes

NONE = 0
BITSHUFFLE_RLE = 1
BITSHUFFLE_ZSTD = 2
DEFLATE = 3

_NAMES = {
    NONE: "none",
    BITSHUFFLE_RLE: "bitshuffle-rle",
    BITSHUFFLE_ZSTD: "bitshuffle-zstd",
    DEFLATE: "deflate",
}
_CODES = {v: k for k, v in _NAMES.items()}

DEFAULT_SEG_BLOCKS = 256       # blocks per ROI-addressable shuffle segment
DEFLATE_LEVEL = 2
ZSTD_LEVEL = 3
_TABLE = struct.Struct("<HI")  # seg_blocks u16 | nseg u32


def _zstd():
    """The zstandard module, or None (absent, or disabled via
    ``SZX_STAGE_DISABLE_ZSTD=1``)."""
    if os.environ.get("SZX_STAGE_DISABLE_ZSTD"):
        return None
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def name_of(code: int) -> str:
    return _NAMES.get(code, f"#{code}")


def resolve(stage) -> int:
    """Normalize a user-facing stage spec (None/name/code) to a stage code.

    Raises on unknown names/codes and on known stages whose dependency is
    missing -- a writer must not emit frames it could not read back.
    """
    if stage is None or stage == NONE or stage == "none":
        return NONE
    if isinstance(stage, str):
        if stage not in _CODES:
            raise ValueError(
                f"unknown second stage {stage!r}; expected one of "
                f"{sorted(_CODES)}"
            )
        code = _CODES[stage]
    elif isinstance(stage, int) and not isinstance(stage, bool):
        if stage not in _NAMES:
            raise ValueError(
                f"unknown second stage code {stage}; expected one of "
                f"{sorted(_NAMES)}"
            )
        code = stage
    else:
        raise TypeError(f"stage must be a name, code, or None; got {stage!r}")
    if code == BITSHUFFLE_ZSTD and _zstd() is None:
        raise ValueError(
            "second stage 'bitshuffle-zstd' needs the zstandard package "
            "(not installed); use stage='deflate' or 'bitshuffle-rle'"
        )
    return code


def require_readable(code: int) -> None:
    """Fail loudly when this reader cannot destage ``code``."""
    if code == NONE:
        return
    if code not in _NAMES:
        raise ValueError(
            f"stream requires second stage #{code}, which this reader does "
            "not implement (newer writer?)"
        )
    if code == BITSHUFFLE_ZSTD and _zstd() is None:
        raise ValueError(
            "stream requires second stage 'bitshuffle-zstd' but the "
            "zstandard package is not installed"
        )


# ---------------------------------------------------------------------------
# byteplane-major shuffle permutation
# ---------------------------------------------------------------------------

def _plane_perm(sec, lo_b: int, hi_b: int, seg_blocks: int) -> torch.Tensor:
    """Permutation grouping the mid bytes of blocks [lo_b, hi_b) by byteplane
    within each segment of ``seg_blocks`` blocks (``lo_b`` is a segment
    start): ``planar = mid[perm]``, offsets relative to block ``lo_b``'s
    first mid byte, int64 on the sections' device.

    The j-th stored byte of a value with lead count L sits in plane ``L +
    j``.  Within a segment the order is plane k ascending, then value index
    ascending -- a stable sort of every (value, plane) pair by (segment,
    plane), which is the reference's per-plane pass, segment by segment.
    Derived entirely from the raw metadata prefix: no side data.
    """
    L = sec.L[lo_b:hi_b].to(torch.int64)
    nbytes = sec.nbytes[lo_b:hi_b].to(torch.int64)
    nbr, bs = L.shape
    W = sec.plan.dtype.itemsize
    dev = L.device
    counts = (nbytes[:, None] - L).clamp(min=0).reshape(-1)
    starts = torch.cumsum(counts, 0) - counts
    Lf = L.reshape(-1)
    seg = torch.arange(nbr * bs, device=dev, dtype=torch.int64) // (bs * seg_blocks)
    k = torch.arange(W, device=dev, dtype=torch.int64)[:, None]            # (W, 1)
    stored = (Lf <= k) & (counts > k - Lf)                                 # (W, nvals)
    key = torch.where(stored, seg * W + k, torch.iinfo(torch.int64).max)
    order = torch.sort(key.reshape(-1), stable=True).indices
    mlo, mhi = sec.mid_range(lo_b, hi_b)
    return (starts + (k - Lf)).reshape(-1)[order[: mhi - mlo]]


def _positions(dev, lens: list[int], starts: list[int]) -> torch.Tensor:
    """For the concatenation of pieces of ``lens`` bytes, the index of each
    byte in a buffer where piece s begins at ``starts[s]`` (int64)."""
    total = sum(lens)
    begin = np.cumsum([0] + lens[:-1])
    delta = torch.tensor(np.asarray(starts, np.int64) - begin, device=dev)
    return torch.arange(total, device=dev, dtype=torch.int64) + torch.repeat_interleave(
        delta, torch.tensor(lens, device=dev), output_size=total)


# ---------------------------------------------------------------------------
# inner codecs
# ---------------------------------------------------------------------------

def _rle_encode(b: np.ndarray) -> bytes:
    """(value, run-length) byte pairs; runs longer than 255 split."""
    if b.size == 0:
        return b""
    change = np.flatnonzero(b[1:] != b[:-1])
    starts = np.concatenate(([0], change + 1))
    lens = np.diff(np.concatenate((starts, [b.size])))
    vals = b[starts]
    rep = (lens + 254) // 255
    vals = np.repeat(vals, rep)
    out_lens = np.full(vals.size, 255, np.uint8)
    out_lens[np.cumsum(rep) - 1] = (lens - (rep - 1) * 255).astype(np.uint8)
    out = np.empty(vals.size * 2, np.uint8)
    out[0::2] = vals
    out[1::2] = out_lens
    return out.tobytes()


def _rle_decode(body: bytes, expect: int) -> np.ndarray:
    pairs = np.frombuffer(body, np.uint8)
    if pairs.size % 2:
        raise ValueError("corrupt second-stage payload (odd RLE pair bytes)")
    vals = pairs[0::2]
    lens = pairs[1::2].astype(np.int64)
    if vals.size and int(lens.min(initial=1)) == 0:
        raise ValueError("corrupt second-stage payload (zero-length RLE run)")
    out = np.repeat(vals, lens)
    if out.size != expect:
        raise ValueError(
            f"corrupt second-stage payload (RLE expands to {out.size} bytes, "
            f"segment holds {expect})"
        )
    return out


def _inflate(body: bytes, raw_len: int) -> bytes:
    try:
        out = zlib.decompress(body)
    except zlib.error as err:
        raise ValueError(f"corrupt second-stage payload (deflate: {err})") from err
    if len(out) != raw_len:
        raise ValueError(
            f"corrupt second-stage payload (deflate yields {len(out)} "
            f"bytes, segment holds {raw_len})"
        )
    return out


def _unpack_tiles(code: int, body: bytes, padded: int) -> np.ndarray:
    """A staged bitshuffle record body -> its ``padded`` shuffled bytes."""
    if code == BITSHUFFLE_RLE:
        return _rle_decode(body, padded)
    if code != BITSHUFFLE_ZSTD:
        raise ValueError(f"unknown second stage code {code}")
    try:
        sh = _zstd().ZstdDecompressor().decompress(body, max_output_size=padded)
    except Exception as err:      # zstandard raises its own ZstdError
        raise ValueError(f"corrupt second-stage payload (zstd: {err})") from err
    if len(sh) != padded:
        raise ValueError(
            f"corrupt second-stage payload (zstd yields {len(sh)} "
            f"bytes, segment holds {padded})"
        )
    return np.frombuffer(sh, np.uint8)


# ---------------------------------------------------------------------------
# frame payload stage / destage
# ---------------------------------------------------------------------------

def _seg_ranges(nb: int, seg_blocks: int, s_lo: int = 0, s_hi: int | None = None):
    s_hi = -(-nb // seg_blocks) if s_hi is None else s_hi
    for s in range(s_lo, s_hi):
        yield s * seg_blocks, min((s + 1) * seg_blocks, nb)


def _shuffle_segments(sec, mid: np.ndarray, seg_blocks: int, dev) -> list[np.ndarray]:
    """Forward byteplane shuffle + bit transpose of every segment of a frame:
    the shuffled tile bytes of each segment (host), from one copy of the mid
    bytes to the device, one gather, one bitshuffle launch and one copy
    back."""
    spec = sec.plan.dtype
    T = tile_bytes(spec)
    nb = sec.plan.nblocks
    ranges = [sec.mid_range(lo, hi) for lo, hi in _seg_ranges(nb, seg_blocks)]
    lens = [hi - lo for lo, hi in ranges]
    ntiles = [-(-n // T) for n in lens]
    tile0 = np.cumsum([0] + ntiles)
    planar = to_device(mid, dev)[_plane_perm(sec, 0, nb, seg_blocks)]
    padded = torch.zeros(int(tile0[-1]) * T, dtype=torch.uint8, device=dev)
    padded[_positions(dev, lens, [int(t) * T for t in tile0[:-1]])] = planar
    shuffled = ops.bitshuffle(padded.reshape(-1, T), spec=spec)
    host = to_host(shuffled).numpy().reshape(-1)
    return [host[tile0[s] * T: tile0[s + 1] * T] for s in range(len(lens))]


def stage_payload(payload, code: int, *, seg_blocks: int = DEFAULT_SEG_BLOCKS,
                  device=None) -> bytes | None:
    """Apply stage ``code`` to one v2 payload on ``device``; None when it
    would not shrink.

    The metadata prefix is copied verbatim; the mid section becomes the stage
    table + per-segment records.  ``None`` (negotiation declined: empty mid,
    or staged >= raw) means the caller must write the frame stage-off.
    """
    if code == NONE:
        return None
    dev = resolve_device(device, "stage_payload")
    track = obs.enabled()
    if track:
        obs.counter("codec.stage.try", stage=name_of(code)).inc()
    if not 0 < seg_blocks <= 0xFFFF:
        raise ValueError(f"seg_blocks {seg_blocks} out of range [1, 65535]")
    buf = bytes(payload) if not isinstance(payload, (bytes, bytearray)) else payload
    prefix_len = container.stream_prefix_length(buf)
    sec = container.parse_stream_sections(buf[:prefix_len], device=dev)
    nb = sec.plan.nblocks
    if sec.nmid == 0 or nb == 0:
        if track:
            obs.counter("codec.stage.fallback", stage=name_of(code)).inc()
        return None
    mid = np.frombuffer(buf, np.uint8, sec.nmid, prefix_len)
    segs = [mid[slice(*sec.mid_range(lo, hi))] for lo, hi in _seg_ranges(nb, seg_blocks)]
    if code == DEFLATE:
        # natural order: the byteplane shuffle buys deflate little ratio for
        # more time than deflate itself takes
        bodies = [zlib.compress(seg.tobytes(), DEFLATE_LEVEL) for seg in segs]
    elif code == BITSHUFFLE_RLE:
        bodies = [_rle_encode(sh) for sh in _shuffle_segments(sec, mid, seg_blocks, dev)]
    elif code == BITSHUFFLE_ZSTD:
        z = _zstd().ZstdCompressor(level=ZSTD_LEVEL)
        bodies = [z.compress(sh.tobytes()) for sh in _shuffle_segments(sec, mid, seg_blocks, dev)]
    else:
        raise ValueError(f"unknown second stage code {code}")
    records = [b"\x01" + body if len(body) < seg.size else b"\x00" + seg.tobytes()
               for seg, body in zip(segs, bodies)]
    table = _TABLE.pack(seg_blocks, len(records)) + np.asarray(
        [len(r) for r in records], dtype="<u4"
    ).tobytes()
    staged_len = prefix_len + len(table) + sum(len(r) for r in records)
    if staged_len >= len(buf):
        if track:
            obs.counter("codec.stage.fallback", stage=name_of(code)).inc()
        return None
    if track:
        name = name_of(code)
        seg_staged = sum(r[0] == 1 for r in records)
        obs.counter("codec.stage.win", stage=name).inc()
        obs.counter("codec.stage.segments_staged", stage=name).inc(seg_staged)
        obs.counter("codec.stage.segments_raw", stage=name).inc(len(records) - seg_staged)
        obs.counter("codec.stage.mid_bytes_in", stage=name).inc(int(sec.nmid))
        obs.counter("codec.stage.mid_bytes_out", stage=name).inc(staged_len - prefix_len)
    return b"".join([buf[:prefix_len], table, *records])


def _check_table(seg_blocks: int, nseg: int, nb: int) -> None:
    if seg_blocks == 0:
        raise ValueError("corrupt second-stage payload (seg_blocks == 0)")
    if nseg != -(-nb // seg_blocks):
        raise ValueError(
            f"corrupt second-stage payload (stage table has {nseg} segments, "
            f"{nb} blocks at {seg_blocks}/segment need {-(-nb // seg_blocks)})"
        )


def _destage_records(sec, code: int, records: list[bytes], s_lo: int,
                     seg_blocks: int, dev) -> bytes:
    """Natural-order mid bytes of segments ``s_lo, s_lo + 1, ...`` from their
    records.  Every bitshuffle-staged record's tiles cross to the device in
    one copy, with the raw records' bytes, for ONE inverse bitshuffle, one
    inverse permutation and one copy back."""
    spec = sec.plan.dtype
    T = tile_bytes(spec)
    nb = sec.plan.nblocks
    s_hi = s_lo + len(records)
    lens, natural, tiles, shuffled = [], [], [], []
    for record, (lo, hi) in zip(records, _seg_ranges(nb, seg_blocks, s_lo, s_hi)):
        mlo, mhi = sec.mid_range(lo, hi)
        raw_len = mhi - mlo
        if len(record) < 1:
            raise ValueError("corrupt second-stage payload (empty segment record)")
        mode, body = record[0], record[1:]
        if mode == 0:
            if len(body) != raw_len:
                raise ValueError(
                    f"corrupt second-stage payload (raw segment has {len(body)} "
                    f"bytes, expected {raw_len})"
                )
        elif mode != 1:
            raise ValueError(f"corrupt second-stage payload (unknown segment mode {mode})")
        elif code == DEFLATE:
            body = _inflate(body, raw_len)
        else:
            tiles.append(_unpack_tiles(code, body, -(-raw_len // T) * T))
        lens.append(raw_len)
        shuffled.append(mode == 1 and code != DEFLATE)
        natural.append(b"" if shuffled[-1] else body)
    if not tiles:
        return b"".join(natural)
    ntile_bytes = sum(t.size for t in tiles)
    host = np.concatenate(tiles + [np.frombuffer(b"".join(natural), np.uint8)])
    up = to_device(host, dev)
    src = torch.cat([ops.bitshuffle(up[:ntile_bytes].reshape(-1, T), spec=spec,
                                    inverse=True).reshape(-1), up[ntile_bytes:]])
    # where each segment's bytes start in src: tiles first, then raw bytes
    starts, t_off, r_off = [], 0, ntile_bytes
    for n, sh in zip(lens, shuffled):
        starts.append(t_off if sh else r_off)
        if sh:
            t_off += -(-n // T) * T
        else:
            r_off += n
    planar = src[_positions(dev, lens, starts)]
    total = sum(lens)
    perm = _plane_perm(sec, s_lo * seg_blocks, min(s_hi * seg_blocks, nb), seg_blocks)
    is_shuffled = torch.repeat_interleave(
        torch.tensor(shuffled, device=dev), torch.tensor(lens, device=dev), output_size=total)
    dest = torch.where(is_shuffled, perm, torch.arange(total, device=dev))
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    out[dest] = planar
    return to_host(out).numpy().tobytes()


def destage_payload(payload, code: int, *, device=None) -> bytes:
    """Invert :func:`stage_payload` on ``device``: staged payload -> raw v2
    stream bytes."""
    require_readable(code)
    dev = resolve_device(device, "destage_payload")
    buf = bytes(payload) if not isinstance(payload, (bytes, bytearray)) else payload
    prefix_len = container.stream_prefix_length(buf)
    sec = container.parse_stream_sections(buf[:prefix_len], device=dev)
    nb = sec.plan.nblocks
    if len(buf) < prefix_len + _TABLE.size:
        raise ValueError("corrupt second-stage payload (truncated stage table)")
    seg_blocks, nseg = _TABLE.unpack_from(buf, prefix_len)
    _check_table(seg_blocks, nseg, nb)
    off = prefix_len + _TABLE.size
    if len(buf) < off + 4 * nseg:
        raise ValueError("corrupt second-stage payload (truncated stage table)")
    lens = np.frombuffer(buf, "<u4", nseg, off).astype(np.int64)
    off += 4 * nseg
    if off + int(lens.sum()) != len(buf):
        raise ValueError(
            "corrupt second-stage payload (segment records do not span the "
            "frame payload)"
        )
    bounds = off + np.concatenate(([0], np.cumsum(lens)))
    records = [buf[int(a):int(b)] for a, b in zip(bounds[:-1], bounds[1:])]
    return buf[:prefix_len] + _destage_records(sec, code, records, 0, seg_blocks, dev)


# ---------------------------------------------------------------------------
# ROI partial reads over staged frames
# ---------------------------------------------------------------------------

def read_mid_range(f, table_offset: int, sec, code: int, lo_b: int,
                   hi_b: int, *, device=None) -> bytes:
    """Read + destage EXACTLY blocks [lo_b, hi_b)'s mid bytes from a staged
    frame in an open seekable stream, on ``device``.

    ``table_offset`` is the file offset of the stage table (frame payload
    start + metadata prefix length); ``sec`` the frame's parsed sections.
    Reads the stage table plus only the segment records overlapping the
    block range (one contiguous read), so bytes read scale with the ROI.
    Returns ``sec.mid_range(lo_b, hi_b)`` bytes.
    """
    require_readable(code)
    dev = resolve_device(device, "read_mid_range")
    nb = sec.plan.nblocks
    f.seek(table_offset)
    seg_blocks, nseg = _TABLE.unpack_from(container._read_exact(f, _TABLE.size), 0)
    _check_table(seg_blocks, nseg, nb)
    lens = np.frombuffer(container._read_exact(f, 4 * nseg), "<u4").astype(np.int64)
    if not 0 <= lo_b < hi_b <= nb:
        raise ValueError(f"block range [{lo_b}, {hi_b}) out of [0, {nb})")
    s_lo = lo_b // seg_blocks
    s_hi = -(-hi_b // seg_blocks)
    starts = np.concatenate(([0], np.cumsum(lens)))
    f.seek(table_offset + _TABLE.size + 4 * nseg + int(starts[s_lo]))
    blob = container._read_exact(f, int(starts[s_hi] - starts[s_lo]))
    if obs.enabled():
        obs.counter("codec.stage.roi_bytes_read", stage=name_of(code)).inc(
            _TABLE.size + 4 * nseg + len(blob))
    cuts = starts[s_lo:s_hi + 1] - starts[s_lo]
    records = [blob[int(a):int(b)] for a, b in zip(cuts[:-1], cuts[1:])]
    seg_mid = _destage_records(sec, code, records, s_lo, seg_blocks, dev)
    base = sec.mid_range(s_lo * seg_blocks, min(s_hi * seg_blocks, nb))[0]
    mlo, mhi = sec.mid_range(lo_b, hi_b)
    return seg_mid[mlo - base: mhi - base]
