"""SZx pack (the two-call encode's second half): CUDA kernel and its plain
version.

The kernel is ``csrc/pack.cu`` (Hopper, ``sm_90a``), which replaces the
Pallas TPU kernel ``repro/kernels/pack.py::pack``.  The plain version is
:func:`repro_torch.kernels.ref.pack_ref`.  :func:`pack` takes the plain
version for a CPU tensor only; a CUDA tensor launches the kernel or raises.

``shift`` and ``nbytes`` are the caller's, never recomputed (the paper's
Fig. 6 analysis packs with ``shift = 0``).  L and mid come back as int32,
the reference's dtypes (the fused encode keeps L as one byte).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref, specs
from repro_torch.kernels.specs import DtypeSpec

LAUNCHES = 0          # kernel launches by pack() since the last reset
_COUNT_LOCK = threading.Lock()

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
    + [ctypes.c_void_p] * 7


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def pack_plain(xb, mu, shift, nbytes, spec: DtypeSpec = specs.F32):
    """:func:`ref.pack_ref` with L as int32, as :func:`pack` returns it."""
    planes, L, mid = ref.pack_ref(xb, mu, shift, nbytes, spec)
    return planes, L.to(torch.int32), mid


def pack(xb: torch.Tensor, mu: torch.Tensor, shift: torch.Tensor, nbytes: torch.Tensor,
         *, spec: DtypeSpec = specs.F32):
    """(nb, bs) blocks + per-block mu (spec dtype), shift and nbytes (int32,
    shift in [0, 8 * itemsize)) -> (planes (nb, itemsize, bs) uint8, L (nb,
    bs) int32, mid (nb, bs) int32)."""
    if xb.device.type == "cpu":
        return pack_plain(xb, mu, shift, nbytes, spec)
    if xb.device.type != "cuda":
        raise ValueError(f"pack: unsupported device {xb.device}")
    if xb.dtype != spec.dtype or xb.dim() != 2 or not xb.is_contiguous():
        raise ValueError(
            f"pack: expected contiguous (nb, bs) {spec.name}, got "
            f"{tuple(xb.shape)} {xb.dtype} contiguous={xb.is_contiguous()}"
        )
    nb, bs = xb.shape
    dev = xb.device
    for name, t, dt in (("mu", mu, spec.dtype), ("shift", shift, torch.int32),
                        ("nbytes", nbytes, torch.int32)):
        if t.dtype != dt or t.shape != (nb,) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"pack: {name} must be a contiguous ({nb},) {dt} on {dev}")
    planes = torch.empty((nb, spec.itemsize, bs), dtype=torch.uint8, device=dev)
    L = torch.empty((nb, bs), dtype=torch.int32, device=dev)
    mid = torch.empty((nb, bs), dtype=torch.int32, device=dev)
    if nb:                                   # a grid of 0 is refused
        fn = _build.function("pack", "szx_pack", _ARGTYPES)
        rc = _build.launch(fn, dev, (spec.code, xb.data_ptr(), nb, bs, mu.data_ptr(),
                                     shift.data_ptr(), nbytes.data_ptr(), planes.data_ptr(),
                                     L.data_ptr(), mid.data_ptr()))
        if rc:
            raise RuntimeError(f"pack kernel launch failed (CUDA error {rc})")
        _count_launch()
    return planes, L, mid
