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

The body sections are laid out on the device (``device._assemble_body``) and
parsed there (``kernels.ref.parse_body_ref``); this module holds the header
constants and the frame layer:

  frame header '<4sBBIQ': magic 'SZXF' | version u8 | flags u8 (bit0 = last,
               bit1 = raw, bits 2-4 = second-stage code) | seq u32 |
               payload_len u64

Frames whose flags carry a second-stage code raise ``stream requires second
stage ...``: the stage is not ported yet.
"""
from __future__ import annotations

import io
import json
import struct
import warnings
import zlib
from typing import Iterator

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
STAGE_NAMES = {1: "bitshuffle-rle", 2: "bitshuffle-zstd", 3: "deflate"}

# container v3: a frame sequence MAY be followed by a seekable index footer
# (JSON index payload + fixed trailer at the very end of the stream)
INDEX_MAGIC = b"SZXI"
INDEX_VERSION = 1
INDEX_TRAILER = struct.Struct("<4sBBHQI")   # magic|ver|flags|reserved|len|crc32


def stage_of_flags(flags: int) -> int:
    """Second-stage code recorded in a frame's flag bits (0 = stage-off)."""
    return (flags & FLAG_STAGE_MASK) >> FLAG_STAGE_SHIFT


# ---------------------------------------------------------------------------
# self-delimiting frames (chunked streaming)
# ---------------------------------------------------------------------------

def build_frame(payload: bytes, seq: int, last: bool, *, raw: bool = False,
                stage=None) -> bytes:
    """Wrap one payload (v2 stream, or raw bytes with ``raw=True``) as a
    self-delimiting frame.  Only stage-off frames are written here."""
    if stage is not None:
        raise ValueError(
            f"second stage {stage!r} is not available in repro_torch yet "
            "(stage=None writes stage-off frames)"
        )
    flags = (FLAG_LAST if last else 0) | (FLAG_RAW if raw else 0)
    return FRAME_HEADER.pack(FRAME_MAGIC, FRAME_VERSION, flags, seq, len(payload)) + payload


def destage_frame_payload(payload: bytes, flags: int) -> tuple[bytes, int]:
    """Stage-off frames pass through; frames with stage bits raise the
    fail-loudly ``stream requires second stage ...`` ValueError."""
    code = stage_of_flags(flags)
    if not code:
        return payload, flags
    if flags & FLAG_RAW:
        raise ValueError(
            "corrupt SZx frame (raw frame carries second-stage flag bits)"
        )
    name = STAGE_NAMES.get(code)
    label = f"'{name}'" if name else f"#{code}"
    raise ValueError(
        f"stream requires second stage {label}, which this reader does "
        "not implement"
    )


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


def read_frame_at(f, offset: int, length: int, seq: int) -> tuple[bytes, int]:
    """Random-access read of one frame via its index entry: seek, read
    exactly ``length`` bytes, validate the frame header against ``seq``."""
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
    return destage_frame_payload(frame[FRAME_HEADER.size:], flags)


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


def iter_frames(source, *, with_flags: bool = False) -> Iterator:
    """Yield frame payloads from bytes, a binary file object, or an iterable
    of frame byte strings.  Validates magic, version, sequence numbers, and
    that the sequence terminates with a LAST-flagged frame.  With
    ``with_flags=True`` yields ``(payload, flags)`` pairs instead."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        source = io.BytesIO(source)
    if hasattr(source, "read"):
        it = _iter_frames_file(source)
    else:
        it = _iter_frames_iterable(source)
    for payload, flags in it:
        yield (payload, flags) if with_flags else payload


def _iter_frames_iterable(source) -> Iterator[tuple[bytes, int]]:
    seq_expected = 0
    saw_last = False
    for frame in source:
        if saw_last:
            raise ValueError("SZx frame after the LAST-flagged frame")
        payload, flags = _parse_one_frame(frame, seq_expected)
        saw_last = bool(flags & FLAG_LAST)
        seq_expected += 1
        yield payload, flags
    if seq_expected == 0:
        raise ValueError("empty SZx frame sequence")
    if not saw_last:
        raise ValueError("SZx frame sequence ended without a LAST frame")


def _parse_one_frame(frame: bytes, seq_expected: int) -> tuple[bytes, int]:
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
    return destage_frame_payload(frame[FRAME_HEADER.size:], flags)


def _iter_frames_file(f) -> Iterator[tuple[bytes, int]]:
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
        yield destage_frame_payload(_read_exact(f, plen), flags)
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
