"""Fused SZx stream-body decode: CUDA kernel and its plain version.

The kernel is ``csrc/decode.cu`` (Hopper, ``sm_90a``, two launches: a
one-pass scan of the blocks' stored-byte counts with a decoupled look-back
across tiles, then gather + propagate + compose), which replaces
the Pallas TPU kernel ``repro/kernels/decode.py::decode_body``.  The plain
version is :func:`repro_torch.kernels.ref.decode_body_ref`.
:func:`decode_body` takes the plain version for a CPU tensor only; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref, specs
from repro_torch.kernels.specs import DtypeSpec

decode_body_plain = ref.decode_body_ref

LAUNCHES = 0          # kernel launches by decode_body() since the last reset
_COUNT_LOCK = threading.Lock()

_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_int] + [ctypes.c_longlong] * 4 + [ctypes.c_int]
             + [ctypes.c_void_p] * 9)
_STATUS_ARGTYPES = [ctypes.c_longlong, ctypes.c_int]


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def decode_body(body: torch.Tensor, nnc: int, lo: int, mu, shift, nbytes, rank, *,
                spec: DtypeSpec = specs.F32, bs: int, rb: int,
                rebase: bool = False):
    """Fused stream-body decode -> (vals (rb, bs), mid_total int64 scalar).

    ``body`` is the stream minus its header (uint8); ``nnc`` the header's
    n_nonconst; blocks [lo, lo + rb) are decoded.  Pass the full (nb,)
    metadata vectors from ``ref.parse_body_ref``.
    """
    nb = rank.shape[0]
    if not (0 <= lo and 1 <= rb and lo + rb <= nb and body.numel() > 0):
        raise ValueError(f"decode_body: blocks [{lo}, {lo + rb}) out of [0, {nb})")
    if body.device.type == "cpu":
        return decode_body_plain(body, nnc, lo, mu, shift, nbytes, rank, spec,
                                 bs=bs, rb=rb, rebase=rebase)
    if body.device.type != "cuda":
        raise ValueError(f"decode_body: unsupported device {body.device}")
    for name, t, dt in (("body", body, torch.uint8), ("mu", mu, spec.dtype),
                        ("shift", shift, torch.int32), ("nbytes", nbytes, torch.int32),
                        ("rank", rank, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != body.device:
            raise ValueError(f"decode_body: {name} must be contiguous {dt} on {body.device}")
    W = spec.itemsize
    nbm = (nb + 7) // 8
    l_off = nbm + W * nb + nnc
    mid_off = l_off + (nnc * bs + 3) // 4
    dev = body.device
    n_status = _build.function("decode", "szx_decode_status_len", _STATUS_ARGTYPES)(nb, bs)
    status = torch.zeros(n_status, dtype=torch.int64, device=dev)   # the scan's tile status
    starts = torch.empty(nb, dtype=torch.int64, device=dev)
    mid_total = torch.empty(1, dtype=torch.int64, device=dev)
    out = torch.empty((rb, bs), dtype=spec.dtype, device=dev)
    fn = _build.function("decode", "szx_decode", _ARGTYPES)
    rc = _build.launch(fn, dev, (spec.code, body.data_ptr(), body.numel(), nb, bs, l_off,
                                 mid_off, lo, rb, int(rebase), mu.data_ptr(), shift.data_ptr(),
                                 nbytes.data_ptr(), rank.data_ptr(), status.data_ptr(),
                                 starts.data_ptr(), mid_total.data_ptr(), out.data_ptr()))
    if rc:
        raise RuntimeError(f"decode kernel launch failed (CUDA error {rc})")
    _count_launch()
    return out, mid_total[0]
