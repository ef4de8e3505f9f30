"""szx-planes fixed-plane encode and decode: CUDA kernels and their plain
versions.

The kernels are ``csrc/planes.cu`` (Hopper, ``sm_90a``), which replace the
Pallas TPU kernels ``repro/kernels/planes.py::planes_encode`` and
``::planes_decode``.  The plain versions are
:func:`repro_torch.kernels.ref.planes_encode_ref` and ``planes_decode_ref``.
Each wrapper takes its plain version for a CPU tensor only; a CUDA tensor
launches the kernel or raises.

Leading dims are flattened here, so the kernels see (nb, bs) blocks and
(P, nb, bs) planes; a call with no blocks returns empty outputs without a
launch.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref

planes_encode_plain = ref.planes_encode_ref
planes_decode_plain = ref.planes_decode_ref

ENCODE_LAUNCHES = 0   # planes_encode() kernel launches since the last reset
DECODE_LAUNCHES = 0   # planes_decode() kernel launches since the last reset
_COUNT_LOCK = threading.Lock()

_ENCODE_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p]
_DECODE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p]


def _count_launch(decode: bool) -> None:
    global ENCODE_LAUNCHES, DECODE_LAUNCHES
    with _COUNT_LOCK:
        if decode:
            DECODE_LAUNCHES += 1
        else:
            ENCODE_LAUNCHES += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")


def _launch(name: str, symbol: str, argtypes, dev: torch.device, *args) -> None:
    fn = _build.function("planes", symbol, argtypes)
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {rc})")


def planes_encode(xb: torch.Tensor, num_planes: int):
    """(..., bs) float32 blocks -> (mu (...,) f32, sexp (...,) int32, planes
    (P, ..., bs) uint8)."""
    if not 1 <= num_planes <= 3:
        raise ValueError("szx-planes supports 1..3 byte planes")
    if xb.device.type == "cpu":
        return planes_encode_plain(xb, num_planes)
    _check("planes_encode", xb, torch.float32)
    lead, bs = tuple(xb.shape[:-1]), xb.shape[-1]
    x2 = xb.reshape(-1, bs).contiguous()
    nb = x2.shape[0]
    dev = xb.device
    mu = torch.empty(nb, dtype=torch.float32, device=dev)
    sexp = torch.empty(nb, dtype=torch.int32, device=dev)
    planes = torch.empty((num_planes, nb, bs), dtype=torch.uint8, device=dev)
    if nb and bs:                            # a grid of 0 is refused
        tab = ref.planes_scale_table(dev)
        _launch("planes_encode", "szx_planes_encode", _ENCODE_ARGTYPES, dev,
                x2.data_ptr(), nb, bs, num_planes, tab.data_ptr(), mu.data_ptr(),
                sexp.data_ptr(), planes.data_ptr())
        _count_launch(False)
    return (mu.reshape(lead), sexp.reshape(lead),
            planes.reshape((num_planes,) + lead + (bs,)))


def planes_decode(mu: torch.Tensor, sexp: torch.Tensor, planes: torch.Tensor):
    """Inverse of :func:`planes_encode` -> (..., bs) float32; sexp int32."""
    num_planes = planes.shape[0]
    if not 1 <= num_planes <= 3:
        raise ValueError("szx-planes supports 1..3 byte planes")
    if planes.device.type == "cpu":
        return planes_decode_plain(mu, sexp, planes)
    _check("planes_decode", planes, torch.uint8)
    _check("planes_decode", mu, torch.float32)
    _check("planes_decode", sexp, torch.int32)
    lead, bs = tuple(planes.shape[1:-1]), planes.shape[-1]
    p2 = planes.reshape(num_planes, -1, bs).contiguous()
    nb = p2.shape[1]
    if mu.numel() != nb or sexp.numel() != nb:
        raise ValueError(f"planes_decode: {nb} blocks but mu {tuple(mu.shape)}, "
                         f"sexp {tuple(sexp.shape)}")
    mu1, sexp1 = mu.reshape(-1).contiguous(), sexp.reshape(-1).contiguous()
    dev = planes.device
    out = torch.empty((nb, bs), dtype=torch.float32, device=dev)
    if nb and bs:
        tab = ref.planes_scale_table(dev)
        _launch("planes_decode", "szx_planes_decode", _DECODE_ARGTYPES, dev,
                mu1.data_ptr(), sexp1.data_ptr(), p2.data_ptr(), nb, bs, num_planes,
                tab.data_ptr(), out.data_ptr())
        _count_launch(True)
    return out.reshape(lead + (bs,))
