"""Width-generic dtype specifications for the SZx kernel layer (torch dtypes).

One :class:`DtypeSpec` carries everything the transform needs to run on a
given IEEE-754 float format: the on-stream dtype ``code`` (container header
byte), the storage word geometry (``itemsize``/``exp_bits``/``mant_bits``),
and the *compute* geometry -- the dtype the per-block statistics run in.

Storage vs compute dtype
------------------------
Stats (min/max/mu/radius) run in the **compute dtype**: float32 for words of
up to 4 bytes, float64 for float64.  The two 16-bit formats are exact subsets
of float32, so their stats lose nothing to the upcast.  The binary exponent
``p(x) = floor(log2 x)`` is read from the compute dtype's exponent bit field
(conservative ``-bias`` for zero/subnormals); the scalar error-bound exponent
``p(e)`` is computed exactly on the host (``math.frexp``) and passed into the
kernels.

Words are held in SIGNED integer dtypes of the same width (``word_dtype``):
torch has no shifts or maxima on unsigned 32/64-bit words on the CPU, so the
plain versions reinterpret the float bits as signed words and mask where a
logical shift is needed.  The CUDA kernels use ``uint16_t``/``uint32_t``/
``uint64_t`` and see the same bits.  This module is the bottom of the stack.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DtypeSpec:
    """IEEE-754 geometry of one supported input dtype."""

    code: int
    name: str
    dtype: torch.dtype            # storage dtype
    word_dtype: torch.dtype       # signed integer of the same width (bit view)
    itemsize: int
    exp_bits: int
    mant_bits: int
    exp_bias: int

    @property
    def word_bits(self) -> int:
        return 8 * self.itemsize

    @property
    def lead_cap(self) -> int:
        """Max XOR-lead elision count: the 2-bit L code caps at 3, a 2-byte
        word at its own plane count."""
        return min(3, self.itemsize)

    # ------------------------------------------------------------ compute side
    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float64 if self.itemsize == 8 else torch.float32

    @property
    def compute_word_dtype(self) -> torch.dtype:
        return torch.int64 if self.itemsize == 8 else torch.int32

    @property
    def compute_mant_bits(self) -> int:
        return 52 if self.itemsize == 8 else 23

    @property
    def compute_exp_bits(self) -> int:
        return 11 if self.itemsize == 8 else 8

    @property
    def compute_exp_bias(self) -> int:
        return 1023 if self.itemsize == 8 else 127

    @property
    def stats_rounding_guard(self) -> bool:
        """True for the 16-bit formats, whose stats run in a WIDER compute
        dtype: the radius subtraction can still round below the true block
        deviation, so the constant-block test compares the
        next-representable-up radius against ``e`` to keep the bound strict.
        f32/f64 compute in their own width."""
        return self.compute_dtype != self.dtype


F32 = DtypeSpec(0, "float32", torch.float32, torch.int32, 4, 8, 23, 127)
F64 = DtypeSpec(1, "float64", torch.float64, torch.int64, 8, 11, 52, 1023)
F16 = DtypeSpec(2, "float16", torch.float16, torch.int16, 2, 5, 10, 15)
BF16 = DtypeSpec(3, "bfloat16", torch.bfloat16, torch.int16, 2, 8, 7, 127)

SPECS = [F32, F64, F16, BF16]
BY_CODE = {s.code: s for s in SPECS}
BY_DTYPE = {s.dtype: s for s in SPECS}
BY_NAME = {s.name: s for s in SPECS}


def spec_for(dtype) -> DtypeSpec:
    """Spec of a torch dtype, a numpy dtype (``bfloat16`` by name, so no
    ``ml_dtypes`` import is needed) or a dtype name."""
    if isinstance(dtype, torch.dtype):
        spec = BY_DTYPE.get(dtype)
        label = str(dtype).removeprefix("torch.")
    else:
        label = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        spec = BY_NAME.get(label)
    if spec is None:
        raise TypeError(
            f"unsupported dtype {label}; supported: "
            + ", ".join(s.name for s in SPECS)
        )
    return spec


def spec_for_code(code: int) -> DtypeSpec:
    spec = BY_CODE.get(int(code))
    if spec is None:
        raise ValueError(f"unknown dtype code {code} in SZx stream")
    return spec


TILE_VALUES = 1024          # values per bitshuffle tile


def tile_bytes(spec: DtypeSpec) -> int:
    """Bytes per bitshuffle tile for this dtype geometry (multiple of 8)."""
    return TILE_VALUES * spec.itemsize


def exact_exponent_of(e: float) -> int:
    """Exact floor(log2 e) of a positive python float (Formula 4's p(e))."""
    m, ex = math.frexp(e)  # e = m * 2**ex with 0.5 <= m < 1
    return ex - 1
