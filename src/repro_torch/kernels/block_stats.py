"""SZx per-block statistics (the two-call encode's first half): CUDA kernel
and its plain version.

The kernel is ``csrc/block_stats.cu`` (Hopper, ``sm_90a``), which replaces
the Pallas TPU kernel ``repro/kernels/block_stats.py::block_stats``.  The
plain version is :func:`repro_torch.kernels.ref.block_stats_ref`.
:func:`block_stats` takes the plain version for a CPU tensor only; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref, specs
from repro_torch.kernels.specs import DtypeSpec

block_stats_plain = ref.block_stats_ref

LAUNCHES = 0          # kernel launches by block_stats() since the last reset
_COUNT_LOCK = threading.Lock()

_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_double, ctypes.c_int] + [ctypes.c_void_p] * 7


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def block_stats(xb: torch.Tensor, e: float, p_e: int, *, spec: DtypeSpec = specs.F32):
    """(nb, bs) blocks in the spec's dtype -> (mu, radius, const, reqlen,
    shift, nbytes), each (nb,): mu in the spec's dtype, radius in its
    compute dtype, const bool, the rest int32 (0 for constant blocks).
    ``e`` is the absolute bound, ``p_e`` its exact floor(log2)."""
    if xb.device.type == "cpu":
        return block_stats_plain(xb, e, spec, p_e)
    if xb.device.type != "cuda":
        raise ValueError(f"block_stats: unsupported device {xb.device}")
    if xb.dtype != spec.dtype or xb.dim() != 2 or not xb.is_contiguous():
        raise ValueError(
            f"block_stats: expected contiguous (nb, bs) {spec.name}, got "
            f"{tuple(xb.shape)} {xb.dtype} contiguous={xb.is_contiguous()}"
        )
    nb, bs = xb.shape
    dev = xb.device
    mu = torch.empty(nb, dtype=spec.dtype, device=dev)
    radius = torch.empty(nb, dtype=spec.compute_dtype, device=dev)
    const = torch.empty(nb, dtype=torch.bool, device=dev)
    reqlen, shift, nbytes = (torch.empty(nb, dtype=torch.int32, device=dev) for _ in range(3))
    if nb:                                   # a grid of 0 is refused
        fn = _build.function("block_stats", "szx_block_stats", _ARGTYPES)
        rc = _build.launch(fn, dev, (spec.code, xb.data_ptr(), nb, bs, float(e), int(p_e),
                                     mu.data_ptr(), radius.data_ptr(), const.data_ptr(),
                                     reqlen.data_ptr(), shift.data_ptr(), nbytes.data_ptr()))
        if rc:
            raise RuntimeError(f"block_stats kernel launch failed (CUDA error {rc})")
        _count_launch()
    return mu, radius, const, reqlen, shift, nbytes
