"""SZx decode from laid-out byte planes: CUDA kernels and their plain versions.

The kernels are ``csrc/unpack.cu`` (Hopper, ``sm_90a``), which replace the
Pallas TPU kernels ``repro/kernels/unpack.py::unpack`` and
``::unpack_dense``.  The plain versions are
:func:`repro_torch.kernels.ref.unpack_ref` and ``unpack_dense_ref``.  Each
wrapper takes its plain version for a CPU tensor only; a CUDA tensor
launches the kernel or raises.

Inputs are the reference's: planes (nb, W, bs) uint8, mu (nb,) in the
spec's dtype, shift/nbytes (nb,) int32 and, for :func:`unpack`, L (nb, bs)
(uint8 on the card; the reference's int32 values).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref, specs
from repro_torch.kernels.specs import DtypeSpec

unpack_plain = ref.unpack_ref
unpack_dense_plain = ref.unpack_dense_ref

LAUNCHES = 0          # unpack() kernel launches since the last reset
DENSE_LAUNCHES = 0    # unpack_dense() kernel launches since the last reset
_COUNT_LOCK = threading.Lock()

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def _count_launch(dense: bool) -> None:
    global LAUNCHES, DENSE_LAUNCHES
    with _COUNT_LOCK:
        if dense:
            DENSE_LAUNCHES += 1
        else:
            LAUNCHES += 1


def _launch(planes, mu, shift, nbytes, L, spec: DtypeSpec) -> torch.Tensor:
    nb, W, bs = planes.shape
    dev = planes.device
    checks = [("planes", planes, torch.uint8), ("mu", mu, spec.dtype),
              ("shift", shift, torch.int32), ("nbytes", nbytes, torch.int32)]
    if L is not None:
        checks.append(("L", L, torch.uint8))
    for name, t, dt in checks:
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"unpack: {name} must be contiguous {dt} on {dev}")
    if W != spec.itemsize or mu.shape != (nb,) or shift.shape != (nb,) \
            or nbytes.shape != (nb,) or (L is not None and L.shape != (nb, bs)):
        raise ValueError(f"unpack: shapes do not match planes {tuple(planes.shape)}")
    out = torch.empty((nb, bs), dtype=spec.dtype, device=dev)
    if nb:                                   # a grid of 0 is refused
        fn = _build.function("unpack", "szx_unpack", _ARGTYPES)
        with torch.cuda.device(dev):
            rc = fn(spec.code, planes.data_ptr(), mu.data_ptr(), shift.data_ptr(),
                    nbytes.data_ptr(), None if L is None else L.data_ptr(), nb, bs,
                    out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"unpack kernel launch failed (CUDA error {rc})")
        _count_launch(L is None)
    return out


def _route(planes: torch.Tensor) -> str:
    if planes.dim() != 3:
        raise ValueError(f"unpack: planes must be (nb, W, bs), got {tuple(planes.shape)}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unpack: unsupported device {planes.device}")
    return planes.device.type


def unpack(planes, mu, shift, nbytes, L, *, spec: DtypeSpec = specs.F32) -> torch.Tensor:
    """Byte planes + XOR-lead counts -> (nb, bs) values in the spec's dtype."""
    if _route(planes) == "cpu":
        return unpack_plain(planes, mu, shift, nbytes, L, spec)
    return _launch(planes, mu, shift, nbytes, L, spec)


def unpack_dense(planes, mu, shift, nbytes, *, spec: DtypeSpec = specs.F32) -> torch.Tensor:
    """All-``L == 0`` fast path; bit-identical to ``unpack(..., L=0)``."""
    if _route(planes) == "cpu":
        return unpack_dense_plain(planes, mu, shift, nbytes, spec)
    return _launch(planes, mu, shift, nbytes, None, spec)
