"""Fixed-shape front-end: PlanesCodec (szx-planes).

The fixed-shape variant of SZx for traffic whose size must not depend on the
data: gradient all-reduces, pipeline activation shifts, KV caches.  It keeps
the paper's structure -- block mu, a bit budget from the radius exponent,
byte-aligned planes -- and trades the per-value XOR leading-byte elision for
a static plane count P in {1, 2, 3}.

All block math goes through ``repro_torch.kernels.ops``, whose route follows
the tensor's device: a CUDA tensor runs the hand-written planes kernels, a
CPU tensor their plain versions.  A tensor stays on its device; a host array
(numpy) goes to ``device``, which defaults to the card and raises without
one (``device="cpu"`` runs the plain route).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.codec.device import DeviceEncoding, resolve_device
from repro_torch.kernels import ops


@dataclass(frozen=True)
class PlanesCodec:
    """Configured fixed-shape codec; instances are cheap and hashable."""

    num_planes: int = 1
    device: Any = None          # where host arrays go; None means the card

    def __post_init__(self):
        if not 1 <= self.num_planes <= 3:
            raise ValueError("szx-planes supports 1..3 byte planes")

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x)).to(
                resolve_device(self.device, "PlanesCodec"))
        return x if dtype is None else x.to(dtype)

    # ----------------------------------------------------------- block level
    def encode_blocks(self, xb) -> tuple:
        """xb (..., bs) f32 -> (mu (...,), sexp (...,) int32, planes (P, ..., bs))."""
        return ops.planes_encode(self._tensor(xb, torch.float32), self.num_planes)

    def decode_blocks(self, mu, sexp, planes):
        """Inverse of :meth:`encode_blocks` -> (..., bs) f32."""
        return ops.planes_decode(self._tensor(mu), self._tensor(sexp), self._tensor(planes))

    # -------------------------------------------------- DeviceEncoding views
    def encode_blocks_device(self, xb) -> DeviceEncoding:
        """:meth:`encode_blocks` as the shared encoding record (kind
        ``"szx-planes"``, arrays mu/sexp/planes)."""
        mu, sexp, planes = self.encode_blocks(xb)
        return DeviceEncoding.make(
            "szx-planes",
            {"mu": mu, "sexp": sexp, "planes": planes},
            num_planes=self.num_planes,
        )

    def decode_encoding(self, enc: DeviceEncoding):
        """Inverse of :meth:`encode_blocks_device` (accepts any integer sexp
        storage dtype -- wire/cache casts are the caller's)."""
        self._check_kind(enc)
        return self.decode_blocks(enc["mu"], enc["sexp"], enc["planes"])

    def encode_last_axis_device(self, x, block: int) -> DeviceEncoding:
        """:meth:`encode_last_axis` as a ``DeviceEncoding`` (the gradient
        all-gather payload)."""
        return DeviceEncoding.make(
            "szx-planes",
            self.encode_last_axis(x, block),
            num_planes=self.num_planes,
            block=block,
        )

    def decode_last_axis_encoding(self, enc: DeviceEncoding, shape, dtype):
        self._check_kind(enc)
        return self.decode_last_axis(enc.arrays, shape, dtype)

    def _check_kind(self, enc) -> None:
        if enc.kind != "szx-planes":
            raise ValueError(f"PlanesCodec cannot decode encoding kind {enc.kind!r}")
        got = enc.info.get("num_planes", self.num_planes)
        if got != self.num_planes:
            raise ValueError(
                f"encoding has {got} planes, codec configured for {self.num_planes}"
            )

    # ------------------------------------------------------------ leaf level
    def encode_last_axis(self, x, block: int) -> dict[str, Any]:
        """Block along the LAST axis only, leading dims untouched; zero-pads
        the last axis to a whole number of blocks."""
        x = self._tensor(x, torch.float32)
        if x.dim() == 0:
            x = x[None]
        pad = (-x.shape[-1]) % block
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
        xb = x.reshape(x.shape[:-1] + (-1, block))
        mu, sexp, planes = self.encode_blocks(xb)
        return {"mu": mu, "sexp": sexp, "planes": planes}

    def decode_last_axis(self, enc: dict[str, Any], shape, dtype):
        """Inverse of :meth:`encode_last_axis`, trimming the pad."""
        xb = self.decode_blocks(enc["mu"], enc["sexp"], enc["planes"])
        shape = tuple(shape)
        last = shape[-1] if shape else 1
        out = xb.reshape(xb.shape[:-2] + (-1,))[..., :last]
        return out.reshape(shape).to(dtype)

    # -------------------------------------------------------------- flat API
    def encode_flat(self, x, block_size: int) -> tuple:
        """Flatten + edge-pad to blocks; returns (mu, sexp, planes) with
        (nb,)-shaped stats -- the layout of ``repro_torch.core.planes``."""
        flat = self._tensor(x, torch.float32).reshape(-1)
        pad = (-flat.numel()) % block_size
        if pad:
            flat = torch.cat([flat, flat[-1:].expand(pad)])
        return self.encode_blocks(flat.reshape(-1, block_size))

    # ------------------------------------------------------------ accounting
    def wire_bytes_per_value(self, block: int) -> float:
        """Bytes/value moved by a collective (vs 4.0 uncompressed fp32):
        P planes plus f32 mu + int16 sexp per block."""
        return self.num_planes + 6.0 / block
