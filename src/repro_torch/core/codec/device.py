"""Device layer: stream assembly and parse on the card, and the encoding record.

An ultra-fast compressor must keep the variable-length block compaction on
the accelerator and move only final bytes across the link.  Encode runs the
fused kernel (``ops.encode_staged``) and lays out every v2 section (const
bitmap, mu words, compacted reqlen, 2-bit L codes, mid-byte stream) as one
contiguous ``uint8`` body on the device (:func:`_assemble_body`); the frame
reaches the host as one small copy of the two section sizes and ONE copy of
exactly the body's bytes.  Decode copies the body to the device once,
parses the sections there, runs the fused decode kernel, and reads back
three measured scalars for validation; the values stay on the device.

Every device-to-host copy goes through :func:`to_host`, every host-to-device
copy of stream bytes through :func:`to_device`.  Offsets are int64
throughout, so no size below device memory is sent anywhere else.  With
telemetry on, the ``device.put.*``/``device.get.*`` counters count the
copies of the three stream operations (``encode_stream``,
``decode_stream``, ``decode_range``) as the port makes them: the decoded
values stay on the device, so a decode's ``get`` is its three measured
scalars, where the reference reads the values back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.codec import container
from repro_torch.core.codec.plan import Plan, spec_for_code
from repro_torch.core.codec.transform import BlockEncoding
from repro_torch.kernels import ops
from repro_torch.kernels.specs import DtypeSpec, exact_exponent_of


@dataclass(frozen=True, eq=False)
class DeviceEncoding:
    """A named bundle of tensors plus static metadata.

    The byte-stream codec uses kind ``"szx-v2"``: array ``body`` (exactly the
    stream body's bytes, on the device) and meta ``plan``, ``nnc``, ``nmid``.
    The fixed-plane codec (``PlanesCodec``: gradient and activation traffic)
    uses kind ``"szx-planes"``: arrays ``mu``, ``sexp``, ``planes`` and meta
    ``num_planes`` (and ``block`` for a leaf blocked along its last axis).
    """

    kind: str
    arrays: dict[str, Any]
    meta: tuple = ()               # sorted (key, value) pairs

    @classmethod
    def make(cls, kind: str, arrays: Mapping[str, Any], **meta) -> "DeviceEncoding":
        return cls(kind, dict(arrays), tuple(sorted(meta.items())))

    @property
    def info(self) -> dict:
        return dict(self.meta)

    def __getitem__(self, key: str):
        return self.arrays[key]

    def replace(self, **arrays) -> "DeviceEncoding":
        """New encoding with some arrays swapped (kind/meta preserved)."""
        unknown = set(arrays) - set(self.arrays)
        if unknown:
            raise KeyError(f"unknown encoding arrays {sorted(unknown)}")
        return DeviceEncoding(self.kind, {**self.arrays, **arrays}, self.meta)


def resolve_device(device, owner: str) -> torch.device:
    """Where an entry point runs: ``None`` means ``"cuda"``, and a card
    that is not there raises rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}: no CUDA device is available; the port runs on the "
            "card (pass device='cpu' to run the plain PyTorch route)"
        )
    return dev


# ---------------------------------------------------------------------------
# the two transfer helpers
# ---------------------------------------------------------------------------

def to_host(t: torch.Tensor) -> torch.Tensor:
    """The one device-to-host copy: ``t`` into pinned host memory (a CPU
    tensor is returned as it is)."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def to_device(raw: np.ndarray, device) -> torch.Tensor:
    """The one host-to-device copy of stream bytes (uint8), staged through
    pinned memory for a CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.from_numpy(raw.copy())
    host = torch.empty(raw.shape, dtype=torch.uint8, pin_memory=True)
    host.numpy()[...] = raw
    return host.to(device, non_blocking=True)


def _count_copy(direction: str, op: str, t) -> None:
    """One host<->device copy of a stream operation (telemetry on)."""
    obs.counter(f"device.{direction}.calls", op=op).inc()
    obs.counter(f"device.{direction}.bytes", op=op).inc(int(t.nbytes))


# ---------------------------------------------------------------------------
# encode: the container byte layout as tensor ops on the device
# ---------------------------------------------------------------------------

def _assemble_body(spec: DtypeSpec, enc: BlockEncoding):
    """Lay out every v2 section as one contiguous uint8 body on the device.

    Selection in mask order keeps order, so the compactions need no
    scatter: the reqlen and L sections take the non-constant rows, and the
    mid stream takes ``planes.permute(0, 2, 1)`` where ``mask[b, v, k] =
    L[b, v] <= k < nbytes[b]`` -- (block, value, byteplane) order.  The two
    selection sizes (nnc, nmid) are read in ONE small copy first, so the
    selections themselves (``nonzero_static``) never sync.  Returns (body,
    nnc, nmid).
    """
    nb, bs = enc.L.shape
    W = spec.itemsize
    dev = enc.L.device
    nbm = (nb + 7) // 8
    nonconst = ~enc.const
    k = torch.arange(W, device=dev)
    mask = (enc.L[:, :, None] <= k) & (k < enc.nbytes[:, None, None])
    sizes = to_host(torch.stack([nonconst.sum(), mask.sum()]))
    if obs.enabled():
        _count_copy("get", "encode_stream", sizes)
    nnc, nmid = sizes.tolist()
    # const bitmap (np.packbits order: MSB-first within each byte)
    cpad = torch.nn.functional.pad(enc.const.to(torch.int32), (0, nbm * 8 - nb))
    weights = torch.arange(7, -1, -1, device=dev, dtype=torch.int32)
    bitmap = (cpad.reshape(nbm, 8) << weights).sum(dim=1).to(torch.uint8)
    # mu words, little-endian bytes
    mu_bytes = enc.mu.contiguous().view(torch.uint8).reshape(-1)
    rows = torch.nonzero_static(nonconst, size=nnc).reshape(-1)
    reqlen = enc.reqlen[rows].to(torch.uint8)
    lcodes = container.pack_2bit(enc.L[rows].reshape(-1))
    # mid stream: value v stores planes L[v] .. nbytes-1, in plane order
    stored = torch.nonzero_static(mask.reshape(-1), size=nmid).reshape(-1)
    mid = enc.planes.permute(0, 2, 1).reshape(-1)[stored]
    body = torch.cat([bitmap, mu_bytes, reqlen, lcodes, mid])
    return body, nnc, nmid


def encode_device(xb: torch.Tensor, p: Plan) -> DeviceEncoding:
    """(nb, bs) blocks -> kind ``"szx-v2"`` encoding on ``xb``'s device."""
    spec = p.dtype
    if p.nblocks == 0:                  # nothing to launch: the empty body
        body = torch.empty(0, dtype=torch.uint8, device=xb.device)
        return DeviceEncoding.make("szx-v2", {"body": body}, plan=p, nnc=0, nmid=0)
    enc = BlockEncoding(*ops.encode_staged(
        xb, p.error_bound, exact_exponent_of(p.error_bound), spec=spec
    ))
    body, nnc, nmid = _assemble_body(spec, enc)
    return DeviceEncoding.make("szx-v2", {"body": body}, plan=p, nnc=nnc, nmid=nmid)


def to_stream(enc: DeviceEncoding) -> bytes:
    """Materialize a ``"szx-v2"`` encoding as one self-contained v2 stream:
    exactly one device-to-host copy, of the body's bytes; the 40-byte header
    is packed on the host."""
    if enc.kind != "szx-v2":
        raise ValueError(f"cannot serialize encoding kind {enc.kind!r}")
    info = enc.info
    p: Plan = info["plan"]
    header = container.HEADER.pack(
        container.MAGIC, container.VERSION, p.dtype.code, p.block_size, p.n,
        p.error_bound, p.nblocks, info["nnc"], info["nmid"],
    )
    body = to_host(enc["body"])
    if obs.enabled():
        _count_copy("get", "encode_stream", body)
    # join copies the pinned body once into the stream object
    return b"".join((header, body.numpy()))


def encode_to_stream(xb: torch.Tensor, p: Plan) -> bytes:
    """Blocks -> final container bytes, the body crossing the link once."""
    return to_stream(encode_device(xb, p))


# ---------------------------------------------------------------------------
# decode: ONE host-to-device copy of the raw body
# ---------------------------------------------------------------------------

def _checked_stream_header(buf):
    """Host-side header-only validation (the reference container's
    messages); returns the unpacked fields + spec + section geometry."""
    if len(buf) < container.HEADER.size:
        raise ValueError("truncated SZx stream (shorter than header)")
    magic, version, dtype_code, bs, n, e, nb, nnc, nmid = (
        container.HEADER.unpack_from(buf, 0)
    )
    if magic != container.MAGIC:
        raise ValueError("bad SZx stream header (magic mismatch)")
    if version != container.VERSION:
        raise ValueError(f"unsupported SZx stream version {version}")
    spec = spec_for_code(dtype_code)                    # raises on unknown code
    if nnc > nb:
        raise ValueError("corrupt SZx stream (n_nonconst > nblocks)")
    if bs == 0 or nb != (n + bs - 1) // bs:
        raise ValueError("corrupt SZx stream (block count mismatch)")
    prefix_len = (
        container.HEADER.size + (nb + 7) // 8 + spec.itemsize * nb + nnc
        + (nnc * bs + 3) // 4
    )
    if len(buf) < prefix_len:
        raise ValueError(
            f"truncated SZx stream ({len(buf)} bytes, metadata sections "
            f"need {prefix_len})"
        )
    return spec, bs, n, nb, nnc, nmid, prefix_len


def _check_measured(meas, nnc: int, nmid: int, spec: DtypeSpec) -> None:
    """Raise the canonical corrupt-stream errors from the data-dependent
    checks the device measured (nonconst count, max nbytes, mid total)."""
    if int(meas[0]) != nnc:
        raise ValueError("corrupt SZx stream (const bitmap / n_nonconst mismatch)")
    if int(meas[1]) > spec.itemsize:
        raise ValueError("corrupt SZx stream (reqlen exceeds dtype width)")
    if int(meas[2]) != nmid:
        raise ValueError("corrupt SZx stream (mid-stream length mismatch)")


def decode_stream(buf, *, device, out: torch.Tensor | None = None,
                  block_range=None) -> torch.Tensor:
    """Decompress ONE v2 stream on ``device`` -> flat (n,) tensor there.

    The 40-byte header is validated on the host; the body crosses the link
    once; parse and fused decode run on the device; three measured scalars
    come back for validation.  With ``out`` (a flat (n,) tensor of the
    stream dtype on ``device``) the result is written in place.
    ``block_range=(lo, hi)`` decodes only those blocks and returns their
    values (the final block's padding clipped).
    """
    spec, bs, n, nb, nnc, nmid, prefix_len = _checked_stream_header(buf)
    expected = prefix_len + nmid
    if len(buf) < expected:
        raise ValueError(
            f"truncated SZx stream ({len(buf)} bytes, expected {expected})"
        )
    lo, hi = (0, nb) if block_range is None else block_range
    if not 0 <= lo < hi <= nb:
        if nb == 0 and block_range is None:          # the empty stream
            if nmid:
                raise ValueError("corrupt SZx stream (mid-stream length mismatch)")
            res = torch.empty(0, dtype=spec.dtype, device=device)
            return res if out is None else out
        raise ValueError(f"block range [{lo}, {hi}) out of [0, {nb})")
    raw = np.frombuffer(buf, np.uint8, expected - container.HEADER.size,
                        container.HEADER.size)
    body = to_device(raw, device)
    vals, meas = ops.decode_staged(
        body, nnc, lo, spec=spec, nb=nb, bs=bs, rb=hi - lo, rebase=False
    )
    meas = to_host(meas)
    if obs.enabled():
        _count_copy("put", "decode_stream", body)
        _count_copy("get", "decode_stream", meas)
    _check_measured(meas, nnc, nmid, spec)
    flat = vals.reshape(-1)[: min(hi * bs, n) - lo * bs]
    if out is not None:
        out.copy_(flat)
        return out
    return flat


def decode_range(prefix: bytes, mid, lo: int, hi: int, *, device) -> torch.Tensor:
    """Decode blocks [lo, hi) from a stream's metadata prefix plus exactly
    that range's mid bytes (the store ROI read layout) -> flat (hi-lo)*bs
    values on ``device``.

    ``prefix[40:] + mid`` has the same section offsets as a full body (the
    mid section simply starts at block ``lo``'s first mid byte), so this is
    the full decode with ``rebase=True``: the kernel re-derives block
    ``lo``'s absolute mid offset from the L-code cumsum and subtracts it.
    One host-to-device copy, the fused decode, three measured scalars back.
    """
    spec, bs, n, nb, nnc, nmid, prefix_len = _checked_stream_header(prefix)
    if not 0 <= lo < hi <= nb:
        raise ValueError(f"block range [{lo}, {hi}) out of [0, {nb})")
    raw = np.concatenate([
        np.frombuffer(prefix, np.uint8, prefix_len - container.HEADER.size,
                      container.HEADER.size),
        np.frombuffer(mid, np.uint8),
    ])
    body = to_device(raw, device)
    vals, meas = ops.decode_staged(
        body, nnc, lo, spec=spec, nb=nb, bs=bs, rb=hi - lo, rebase=True
    )
    meas = to_host(meas)
    if obs.enabled():
        _count_copy("put", "decode_range", body)
        _count_copy("get", "decode_range", meas)
    _check_measured(meas, nnc, nmid, spec)
    return vals.reshape(-1)
