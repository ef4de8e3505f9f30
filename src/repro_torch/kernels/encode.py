"""Fused SZx encode (block stats + pack): CUDA kernel and its plain version.

The kernel is ``csrc/encode.cu`` (Hopper, ``sm_90a``), which replaces the
Pallas TPU kernel ``repro/kernels/encode.py::encode``.  The plain version is
:func:`repro_torch.kernels.ref.encode_ref`.  :func:`encode` takes the plain
version for a CPU tensor only; a CUDA tensor launches the kernel or raises.

Outputs are the fields the container serializes: (mu, const, reqlen, shift,
nbytes, planes, L) with planes in the reference's (nb, W, bs) layout and L
as one uint8 per value (the reference's int32 values).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref, specs
from repro_torch.kernels.specs import DtypeSpec

encode_plain = ref.encode_ref

LAUNCHES = 0          # kernel launches by encode() since the last reset
_COUNT_LOCK = threading.Lock()

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_double, ctypes.c_int] + [ctypes.c_void_p] * 8


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def encode(xb: torch.Tensor, e: float, p_e: int, *, spec: DtypeSpec = specs.F32):
    """(nb, bs) blocks in the spec's dtype -> (mu, const, reqlen, shift,
    nbytes, planes, L).  ``e`` is the absolute bound (rounded to the compute
    dtype on the way in), ``p_e`` its exact floor(log2)."""
    if xb.device.type == "cpu":
        return encode_plain(xb, e, spec, p_e)
    if xb.device.type != "cuda":
        raise ValueError(f"encode: unsupported device {xb.device}")
    if xb.dtype != spec.dtype or xb.dim() != 2 or not xb.is_contiguous():
        raise ValueError(
            f"encode: expected contiguous (nb, bs) {spec.name}, got "
            f"{tuple(xb.shape)} {xb.dtype} contiguous={xb.is_contiguous()}"
        )
    nb, bs = xb.shape
    dev = xb.device
    i32 = dict(dtype=torch.int32, device=dev)
    mu = torch.empty(nb, dtype=spec.dtype, device=dev)
    const = torch.empty(nb, dtype=torch.bool, device=dev)
    reqlen, shift, nbytes = (torch.empty(nb, **i32) for _ in range(3))
    planes = torch.empty((nb, spec.itemsize, bs), dtype=torch.uint8, device=dev)
    L = torch.empty((nb, bs), dtype=torch.uint8, device=dev)
    if nb:                                   # a grid of 0 is refused
        fn = _build.function("encode", "szx_encode", _ARGTYPES)
        with torch.cuda.device(dev):
            rc = fn(spec.code, xb.data_ptr(), nb, bs, float(e), int(p_e),
                    mu.data_ptr(), const.data_ptr(), reqlen.data_ptr(),
                    shift.data_ptr(), nbytes.data_ptr(), planes.data_ptr(),
                    L.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"encode kernel launch failed (CUDA error {rc})")
        _count_launch()
    return mu, const, reqlen, shift, nbytes, planes, L
