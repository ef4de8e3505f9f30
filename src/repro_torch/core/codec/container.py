"""Container layer: stream header, self-delimiting frames, v3 index footer.

The byte layout is the JAX package's, unchanged (docs/FORMAT.md); streams
written by either package decode in the other:

  header  '<4sBBHQdIIQ': magic 'SZXJ' | version u8 | dtype u8 |
          block_size u16 | n u64 | e f64 | nblocks u32 | n_nonconst u32 |
          nmid u64
  const bitmap  ceil(nb/8) bytes (np.packbits order)
  mu            itemsize * nb bytes (input dtype, one per block)
  reqlen        u8 * n_nonconst
  L codes       2-bit * (n_nonconst * block_size), little-endian packed
  mid stream    nmid bytes in (block, value, byteplane) order

The codec's own path lays the body out on the device
(``device._assemble_body``) and parses it there (``kernels.ref.parse_body_ref``).
This module holds the header constants, the host parse of the metadata
prefix that partial readers seek with (:class:`StreamSections`), and the
frame layer:

  frame header '<4sBBIQ': magic 'SZXF' | version u8 | flags u8 (bit0 = last,
               bit1 = raw, bits 2-4 = second-stage code, see stage.py) |
               seq u32 | payload_len u64

Functions that may run the second stage take ``device=``: ``None`` means
the card (and raises without one), ``"cpu"`` runs the plain versions.
"""
from __future__ import annotations

import io
import json
import struct
import warnings
import zlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.codec import plan as plan_mod
from repro_torch.core.codec.plan import Plan
from repro_torch.core.codec.transform import BlockEncoding, derive_layout

MAGIC = b"SZXJ"
VERSION = 2
HEADER = struct.Struct("<4sBBHQdIIQ")

FRAME_MAGIC = b"SZXF"
FRAME_VERSION = 1
FRAME_HEADER = struct.Struct("<4sBBIQ")
FLAG_LAST = 0x01
FLAG_RAW = 0x02        # payload is raw bytes, not a v2 SZx stream (v3 packs)
FLAG_STAGE_SHIFT = 2
FLAG_STAGE_MASK = 0x7 << FLAG_STAGE_SHIFT

# container v3: a frame sequence MAY be followed by a seekable index footer
# (JSON index payload + fixed trailer at the very end of the stream)
INDEX_MAGIC = b"SZXI"
INDEX_VERSION = 1
INDEX_TRAILER = struct.Struct("<4sBBHQI")   # magic|ver|flags|reserved|len|crc32


def stage_of_flags(flags: int) -> int:
    """Second-stage code recorded in a frame's flag bits (0 = stage-off)."""
    return (flags & FLAG_STAGE_MASK) >> FLAG_STAGE_SHIFT


# ---------------------------------------------------------------------------
# 2-bit code packing
# ---------------------------------------------------------------------------

def pack_2bit(codes: torch.Tensor) -> torch.Tensor:
    """codes: (m,) integers in [0, 3] -> ceil(m/4) uint8, four per byte,
    little-endian (c0 | c1<<2 | c2<<4 | c3<<6)."""
    c = torch.nn.functional.pad(codes.to(torch.int32), (0, (-codes.numel()) % 4))
    c = c.reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)).to(torch.uint8)


def unpack_2bit(raw: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_2bit`: the first ``m`` codes as uint8."""
    sh = torch.arange(0, 8, 2, device=raw.device, dtype=torch.int32)
    return ((raw.to(torch.int32)[:, None] >> sh) & 3).reshape(-1)[:m].to(torch.uint8)


# ---------------------------------------------------------------------------
# the mid-byte layout and the metadata prefix
# ---------------------------------------------------------------------------

def _mid_plan(L: torch.Tensor, nbytes: torch.Tensor):
    """Per-value stored-byte counts ``max(nbytes - L, 0)`` (flat, int64) and
    their exclusive prefix sum: each value's offset into the mid stream."""
    counts = (nbytes.to(torch.int64)[:, None] - L.to(torch.int64)).clamp(min=0).reshape(-1)
    return counts, torch.cumsum(counts, 0) - counts


def _copy_mid(L, counts, start, itemsize: int, mid: torch.Tensor) -> torch.Tensor:
    """Scatter a packed mid stream (block, value, byteplane order) into zeroed
    (nb, itemsize, bs) planes: value v's k-th stored byte is plane ``L[v] +
    k`` and sits at mid offset ``start[v] + k``.  One scatter per byte slot,
    int64 indices; values with no k-th byte write to a discarded extra slot,
    so nothing waits on the device for a count."""
    nb, bs = L.shape
    dev = L.device
    v = torch.arange(nb * bs, device=dev, dtype=torch.int64)
    src0 = (v // bs) * (itemsize * bs) + v % bs + L.reshape(-1).to(torch.int64) * bs
    spare = nb * itemsize * bs
    ext = torch.zeros(spare + 1, dtype=torch.uint8, device=dev)
    if mid.numel():
        for k in range(itemsize):
            has = counts > k
            ext[torch.where(has, src0 + k * bs, spare)] = mid[torch.where(has, start + k, 0)]
    return ext[:spare].reshape(nb, itemsize, bs)


@dataclass(frozen=True)
class StreamSections:
    """Parsed metadata sections of one v2 stream -- everything EXCEPT the
    mid-byte stream.

    The partial-decode contract: a reader fetches the small metadata prefix,
    picks a block range, and reads ONLY that range's mid bytes
    (``block_mid_start`` locates them).  The per-block tensors and ``L`` lie
    on the parse's device, where the decode runs; ``block_mid_start`` is a
    host array, because readers seek with it.
    """

    plan: Plan
    const: torch.Tensor            # (nb,) bool
    mu: torch.Tensor               # (nb,) stream dtype
    reqlen: torch.Tensor           # (nb,) int32 (0 for const blocks)
    shift: torch.Tensor            # (nb,) int32
    nbytes: torch.Tensor           # (nb,) int32
    L: torch.Tensor                # (nb, bs) uint8
    nmid: int                      # total mid-stream length (header field)
    mid_offset: int                # byte offset of the mid stream in the stream
    block_mid_start: np.ndarray    # (nb,) int64 exclusive cumsum of block mid bytes
    elided: np.ndarray             # (nb,) bool: blocks with an L > 0 (host)

    def mid_range(self, lo: int, hi: int) -> tuple[int, int]:
        """[start, stop) byte offsets WITHIN the mid stream holding the mid
        bytes of blocks [lo, hi)."""
        nb = self.plan.nblocks
        start = int(self.block_mid_start[lo]) if lo < nb else self.nmid
        stop = int(self.block_mid_start[hi]) if hi < nb else self.nmid
        return start, stop


def stream_prefix_length(header: bytes) -> int:
    """Byte length of the metadata prefix (header through L codes) of a v2
    stream, computed from its 40-byte header alone."""
    if len(header) < HEADER.size:
        raise ValueError("truncated SZx stream (shorter than header)")
    _m, _v, dtype_code, bs, _n, _e, nb, nnc, _nmid = HEADER.unpack_from(header, 0)
    spec = plan_mod.spec_for_code(dtype_code)
    return HEADER.size + (nb + 7) // 8 + spec.itemsize * nb + nnc + (nnc * bs + 3) // 4


def parse_stream_sections(prefix, *, device=None) -> StreamSections:
    """Validate + deserialize the metadata prefix of a v2 stream on the host,
    with the reference's messages; the per-block tensors and L go to
    ``device`` (``None``: the card).

    ``prefix`` must cover at least the metadata sections (header, const
    bitmap, mu, reqlen, L codes); the mid-byte stream may be absent.
    """
    from repro_torch.core.codec.device import resolve_device

    dev = resolve_device(device, "parse_stream_sections")
    buf = bytes(prefix) if not isinstance(prefix, (bytes, bytearray)) else prefix
    if len(buf) < HEADER.size:
        raise ValueError("truncated SZx stream (shorter than header)")
    magic, version, dtype_code, bs, n, e, nb, nnc, nmid = HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError("bad SZx stream header (magic mismatch)")
    if version != VERSION:
        raise ValueError(f"unsupported SZx stream version {version}")
    spec = plan_mod.spec_for_code(dtype_code)           # raises on unknown code
    if nnc > nb:
        raise ValueError("corrupt SZx stream (n_nonconst > nblocks)")
    if bs == 0 or nb != (n + bs - 1) // bs:
        raise ValueError("corrupt SZx stream (block count mismatch)")
    p = plan_mod.plan_for_stream(dtype_code, bs, n, e)
    nbm = (nb + 7) // 8
    nl = (nnc * bs + 3) // 4
    prefix_len = HEADER.size + nbm + spec.itemsize * nb + nnc + nl
    if len(buf) < prefix_len:
        raise ValueError(
            f"truncated SZx stream ({len(buf)} bytes, metadata sections "
            f"need {prefix_len})"
        )
    off = HEADER.size
    const = np.unpackbits(np.frombuffer(buf, np.uint8, nbm, off))[:nb].astype(bool)
    off += nbm
    mu = np.frombuffer(buf, f"<i{spec.itemsize}", nb, off).copy()
    off += spec.itemsize * nb
    reqlen_nc = np.frombuffer(buf, np.uint8, nnc, off)
    off += nnc
    L_nc = unpack_2bit(torch.from_numpy(np.frombuffer(buf, np.uint8, nl, off).copy()),
                       nnc * bs).numpy()
    off += nl
    nc = ~const
    if int(nc.sum()) != nnc:
        raise ValueError("corrupt SZx stream (const bitmap / n_nonconst mismatch)")
    reqlen = np.zeros(nb, np.int32)
    reqlen[nc] = reqlen_nc
    const_t, reqlen_t = torch.from_numpy(const), torch.from_numpy(reqlen)
    shift, nbytes = derive_layout(reqlen_t, const_t)
    nbytes_np = nbytes.numpy()
    if nbytes_np.max(initial=0) > spec.itemsize:
        raise ValueError("corrupt SZx stream (reqlen exceeds dtype width)")
    L = np.zeros((nb, bs), np.uint8)
    L[nc] = L_nc.reshape(nnc, bs)
    elided = np.zeros(nb, bool)
    elided[nc] = L_nc.reshape(nnc, bs).any(axis=1)
    # sum_v max(nbytes - L_v, 0) == bs*nbytes - sum_v min(L_v, nbytes)
    block_counts = nbytes_np.astype(np.int64) * bs
    if nnc:
        block_counts[nc] -= np.minimum(
            L_nc.reshape(nnc, bs), nbytes_np[nc, None]
        ).sum(axis=1, dtype=np.int64)
    ends = np.cumsum(block_counts)
    if (int(ends[-1]) if nb else 0) != nmid:
        raise ValueError("corrupt SZx stream (mid-stream length mismatch)")
    return StreamSections(
        p, const_t.to(dev), torch.from_numpy(mu).view(spec.dtype).to(dev),
        reqlen_t.to(dev), shift.to(dev), nbytes.to(dev), torch.from_numpy(L).to(dev),
        int(nmid), off, ends - block_counts, elided,
    )


def extract_block_range(sec: StreamSections, mid, lo: int, hi: int) -> BlockEncoding:
    """The block encoding of blocks [lo, hi) of a parsed stream, on the
    sections' device.

    ``mid`` (bytes, a uint8 array or tensor) holds EXACTLY those blocks' mid
    bytes (the ``sec.mid_range(lo, hi)`` slice of the mid stream); it
    crosses to the device once.  The block axis is rebased to start at
    ``lo``, so :func:`repro_torch.core.codec.transform.decode_blocks`
    decodes it -- partial decode costs O(hi - lo), not O(nblocks).
    """
    from repro_torch.core.codec.device import to_device

    nb = sec.plan.nblocks
    if not 0 <= lo < hi <= nb:
        raise ValueError(f"block range [{lo}, {hi}) out of [0, {nb})")
    mlo, mhi = sec.mid_range(lo, hi)
    if not isinstance(mid, torch.Tensor):
        mid = np.frombuffer(mid, np.uint8) if not isinstance(mid, np.ndarray) else mid
    if mid.shape[0] != mhi - mlo:
        raise ValueError(
            f"mid-byte range for blocks [{lo}, {hi}) has {mid.shape[0]} bytes, "
            f"expected {mhi - mlo}"
        )
    dev = sec.L.device
    L_r = sec.L[lo:hi]
    nbytes_r = sec.nbytes[lo:hi]
    mid = mid.to(dev) if isinstance(mid, torch.Tensor) else to_device(mid, dev)
    counts, start = _mid_plan(L_r, nbytes_r)
    planes = _copy_mid(L_r, counts, start, sec.plan.dtype.itemsize, mid)
    return BlockEncoding(sec.mu[lo:hi], sec.const[lo:hi], sec.reqlen[lo:hi],
                         sec.shift[lo:hi], nbytes_r, planes, L_r, sec.elided[lo:hi])


def build_stream(p: Plan, enc: BlockEncoding) -> bytes:
    """Serialize one plan + block encoding into a self-contained v2 stream
    (the body laid out by ``device._assemble_body`` on the encoding's
    device, one copy to the host)."""
    from repro_torch.core.codec import device as device_mod

    body, nnc, nmid = device_mod._assemble_body(p.dtype, enc)
    header = HEADER.pack(MAGIC, VERSION, p.dtype.code, p.block_size, p.n,
                         p.error_bound, p.nblocks, nnc, nmid)
    return b"".join((header, device_mod.to_host(body).numpy()))


def parse_stream(buf: bytes, *, device=None) -> tuple[Plan, BlockEncoding]:
    """Validate + deserialize a v2 stream into (plan, block encoding on
    ``device``)."""
    sec = parse_stream_sections(buf, device=device)
    expected = sec.mid_offset + sec.nmid
    if len(buf) < expected:
        raise ValueError(
            f"truncated SZx stream ({len(buf)} bytes, expected {expected})"
        )
    nb = sec.plan.nblocks
    if nb == 0:
        planes = torch.zeros((0, sec.plan.dtype.itemsize, sec.plan.block_size),
                             dtype=torch.uint8, device=sec.L.device)
        return sec.plan, BlockEncoding(sec.mu, sec.const, sec.reqlen, sec.shift,
                                       sec.nbytes, planes, sec.L, sec.elided)
    mid = np.frombuffer(buf, np.uint8, sec.nmid, sec.mid_offset)
    return sec.plan, extract_block_range(sec, mid, 0, nb)


# ---------------------------------------------------------------------------
# self-delimiting frames (chunked streaming)
# ---------------------------------------------------------------------------

def build_frame(payload: bytes, seq: int, last: bool, *, raw: bool = False,
                stage=None, device=None) -> bytes:
    """Wrap one payload (v2 stream, or raw bytes with ``raw=True``) as a
    self-delimiting frame.

    ``stage`` (a ``stage`` name or code) requests the negotiated lossless
    second stage over the payload's mid-byte section, run on ``device``:
    the frame is staged only when that shrinks it (and never for ``raw``
    payloads), so ``stage=...`` can never lose.  Stage-off frames are
    byte-identical to frames built before the stage existed.
    """
    flags = (FLAG_LAST if last else 0) | (FLAG_RAW if raw else 0)
    staged_code = 0
    orig_payload = payload
    if stage is not None and not raw:
        from repro_torch.core.codec import stage as stage_mod

        code = stage_mod.resolve(stage)
        if code:
            staged = stage_mod.stage_payload(payload, code, device=device)
            if staged is not None:
                payload = staged
                flags |= code << FLAG_STAGE_SHIFT
                staged_code = code
    frame = FRAME_HEADER.pack(FRAME_MAGIC, FRAME_VERSION, flags, seq, len(payload)) + payload
    if not raw:
        from repro_torch import obs

        if obs.enabled():
            obs.stream_stats.record_frame_built(orig_payload, len(frame), seq, staged_code)
    return frame


def destage_frame_payload(payload: bytes, flags: int, *, device=None) -> tuple[bytes, int]:
    """Undo a frame's second stage on ``device``: ``(raw v2 payload, flags
    sans stage bits)``.

    Stage-off frames pass through untouched.  Frames whose stage this reader
    cannot run (unknown code, missing optional dependency) raise the
    fail-loudly ``stream requires second stage ...`` ValueError; raw frames
    with stage bits set are rejected as corrupt (writers never emit them).
    """
    code = stage_of_flags(flags)
    if not code:
        return payload, flags
    if flags & FLAG_RAW:
        raise ValueError(
            "corrupt SZx frame (raw frame carries second-stage flag bits)"
        )
    from repro_torch.core.codec import stage as stage_mod

    return stage_mod.destage_payload(payload, code, device=device), flags & ~FLAG_STAGE_MASK


# ---------------------------------------------------------------------------
# container v3: seekable index footer
# ---------------------------------------------------------------------------

def build_index_footer(index: dict) -> bytes:
    """Serialize an index dict as the v3 footer: JSON payload + trailer."""
    payload = json.dumps(index, separators=(",", ":"), default=float).encode()
    # leading sentinel magic: lets a sequential frame reader recognize "the
    # rest of this stream is the index footer" from the first 4 bytes
    return INDEX_MAGIC + payload + INDEX_TRAILER.pack(
        INDEX_MAGIC, INDEX_VERSION, 0, 0, len(payload), zlib.crc32(payload)
    )


def read_index_footer(f) -> dict | None:
    """Read the v3 index footer of a seekable stream; None if absent (v2).

    Corrupt footers (bad CRC, truncated index, unsupported version) raise --
    a stream that CLAIMS to have an index must have a valid one.
    """
    end = f.seek(0, 2)
    if end < INDEX_TRAILER.size:
        return None
    f.seek(end - INDEX_TRAILER.size)
    magic, version, _flags, _res, ilen, crc = INDEX_TRAILER.unpack(
        _read_exact(f, INDEX_TRAILER.size)
    )
    if magic != INDEX_MAGIC:
        return None
    if version != INDEX_VERSION:
        raise ValueError(f"unsupported SZx index footer version {version}")
    if ilen > end - INDEX_TRAILER.size:
        raise ValueError("corrupt SZx index footer (index longer than stream)")
    f.seek(end - INDEX_TRAILER.size - ilen)
    payload = _read_exact(f, ilen)
    if zlib.crc32(payload) != crc:
        raise ValueError("corrupt SZx index footer (CRC mismatch)")
    return json.loads(payload)


def read_index_footer_safe(f) -> dict | None:
    """Corruption-tolerant :func:`read_index_footer`: a bit-flipped or
    truncated footer returns ``None`` after a ``RuntimeWarning`` so callers
    can fall back to a sequential decode."""
    try:
        return read_index_footer(f)
    except (ValueError, json.JSONDecodeError, struct.error) as err:
        warnings.warn(
            f"corrupt container-v3 index footer ({err}); treating the stream "
            "as a sequential (v2) frame sequence",
            RuntimeWarning,
            stacklevel=2,
        )
        return None


def read_frame_at(f, offset: int, length: int, seq: int, *,
                  device=None) -> tuple[bytes, int]:
    """Random-access read of one frame via its index entry: seek, read
    exactly ``length`` bytes, validate the frame header against ``seq``,
    destage on ``device``."""
    f.seek(offset)
    frame = _read_exact(f, length)
    if len(frame) < FRAME_HEADER.size:
        raise ValueError("truncated SZx frame (shorter than frame header)")
    magic, version, flags, fseq, plen = FRAME_HEADER.unpack_from(frame, 0)
    if magic != FRAME_MAGIC:
        raise ValueError("bad SZx frame (magic mismatch)")
    if version != FRAME_VERSION:
        raise ValueError(f"unsupported SZx frame version {version}")
    if fseq != seq:
        raise ValueError(f"SZx index/frame seq mismatch (frame {fseq}, index {seq})")
    if len(frame) != FRAME_HEADER.size + plen:
        raise ValueError("truncated SZx frame (payload length mismatch)")
    return destage_frame_payload(frame[FRAME_HEADER.size:], flags, device=device)


def read_frame_stream_header_at(f, offset: int, seq: int) -> tuple[int, int, bytes]:
    """Random-access 58-byte peek at a frame's headers: seek to ``offset``,
    validate the frame header against ``seq`` and the payload's v2 stream
    header, and return ``(flags, payload_len, stream_header)``.

    The shared entry for every partial reader (store ROI reads, query
    scans); the file position is left right after the stream header.
    """
    f.seek(offset)
    head = _read_exact(f, FRAME_HEADER.size + HEADER.size)
    magic, version, flags, fseq, plen = FRAME_HEADER.unpack_from(head, 0)
    if magic != FRAME_MAGIC:
        raise ValueError("bad SZx frame (magic mismatch)")
    if version != FRAME_VERSION:
        raise ValueError(f"unsupported SZx frame version {version}")
    if fseq != seq:
        raise ValueError(f"SZx index/frame seq mismatch (frame {fseq}, index {seq})")
    if plen < HEADER.size:
        raise ValueError("truncated SZx stream (shorter than header)")
    sheader = head[FRAME_HEADER.size:]
    if sheader[:4] != MAGIC:
        raise ValueError("bad SZx stream header (magic mismatch)")
    if sheader[4] != VERSION:
        raise ValueError(f"unsupported SZx stream version {sheader[4]}")
    return flags, plen, sheader


def _read_exact(f, size: int) -> bytes:
    data = f.read(size)
    if len(data) != size:
        raise ValueError(
            f"truncated SZx frame sequence (wanted {size} bytes, got {len(data)})"
        )
    return data


def peek_stream_meta(payload: bytes) -> tuple[int, int, float]:
    """(dtype code, element count, absolute bound) of one v2 payload's
    header -- the layout-aware peek for index builders and `info` tools."""
    if len(payload) < HEADER.size:
        raise ValueError("truncated SZx stream (shorter than header)")
    _m, _v, dtype_code, _bs, n, e, _nb, _nnc, _nmid = HEADER.unpack_from(payload, 0)
    return dtype_code, n, e


def iter_frames(source, *, with_flags: bool = False, device=None) -> Iterator:
    """Yield frame payloads from bytes, a binary file object, or an iterable
    of frame byte strings, destaging staged frames on ``device``.  Validates
    magic, version, sequence numbers, and that the sequence terminates with
    a LAST-flagged frame.  With ``with_flags=True`` yields ``(payload,
    flags)`` pairs instead."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        source = io.BytesIO(source)
    if hasattr(source, "read"):
        it = _iter_frames_file(source, device)
    else:
        it = _iter_frames_iterable(source, device)
    for payload, flags in it:
        yield (payload, flags) if with_flags else payload


def _iter_frames_iterable(source, device) -> Iterator[tuple[bytes, int]]:
    seq_expected = 0
    saw_last = False
    for frame in source:
        if saw_last:
            raise ValueError("SZx frame after the LAST-flagged frame")
        payload, flags = _parse_one_frame(frame, seq_expected, device)
        saw_last = bool(flags & FLAG_LAST)
        seq_expected += 1
        yield payload, flags
    if seq_expected == 0:
        raise ValueError("empty SZx frame sequence")
    if not saw_last:
        raise ValueError("SZx frame sequence ended without a LAST frame")


def _parse_one_frame(frame: bytes, seq_expected: int, device) -> tuple[bytes, int]:
    if len(frame) < FRAME_HEADER.size:
        raise ValueError("truncated SZx frame (shorter than frame header)")
    magic, version, flags, seq, plen = FRAME_HEADER.unpack_from(frame, 0)
    if magic != FRAME_MAGIC:
        raise ValueError("bad SZx frame (magic mismatch)")
    if version != FRAME_VERSION:
        raise ValueError(f"unsupported SZx frame version {version}")
    if seq != seq_expected:
        raise ValueError(f"SZx frame out of order (seq {seq}, expected {seq_expected})")
    if len(frame) != FRAME_HEADER.size + plen:
        raise ValueError("truncated SZx frame (payload length mismatch)")
    return destage_frame_payload(frame[FRAME_HEADER.size:], flags, device=device)


def _iter_frames_file(f, device) -> Iterator[tuple[bytes, int]]:
    seq_expected = 0
    while True:
        if seq_expected == 0:
            hdr = f.read(FRAME_HEADER.size)
            if not hdr:
                raise ValueError("empty SZx frame sequence")
            if len(hdr) != FRAME_HEADER.size:
                raise ValueError(
                    f"truncated SZx frame sequence (wanted {FRAME_HEADER.size} "
                    f"bytes, got {len(hdr)})"
                )
        else:
            hdr = _read_exact(f, FRAME_HEADER.size)
        magic, version, flags, seq, plen = FRAME_HEADER.unpack(hdr)
        if magic != FRAME_MAGIC:
            raise ValueError("bad SZx frame (magic mismatch)")
        if version != FRAME_VERSION:
            raise ValueError(f"unsupported SZx frame version {version}")
        if seq != seq_expected:
            raise ValueError(
                f"SZx frame out of order (seq {seq}, expected {seq_expected})"
            )
        yield destage_frame_payload(_read_exact(f, plen), flags, device=device)
        seq_expected += 1
        if flags & FLAG_LAST:
            # v3 streams carry an index footer after the LAST frame.  A
            # further frame (FRAME_MAGIC) is always an error; any OTHER
            # trailing bytes are most plausibly a corrupted footer, and the
            # frames themselves are intact, so tolerate them with a warning
            tail = f.read(len(INDEX_MAGIC))
            if tail and tail != INDEX_MAGIC:
                if tail.startswith(FRAME_MAGIC[: len(tail)]):
                    raise ValueError("SZx frame after the LAST-flagged frame")
                warnings.warn(
                    "ignoring unrecognized trailing bytes after the LAST "
                    "SZx frame (corrupt index footer?)",
                    RuntimeWarning,
                    stacklevel=3,
                )
            return
