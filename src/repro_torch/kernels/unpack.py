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

Each kernel has two routes, picked by :func:`route` from the shape and the
pointers' alignment alone: the vector route (a lane decodes four values of
a block) and the scalar route (a warp a block, a value a lane) for every
other shape.  A failed launch raises on either; nothing falls back to the
other route.
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
# the same launches by route ("unpack_vector", "unpack_scalar",
# "unpack_dense_vector", "unpack_dense_scalar")
ROUTE_LAUNCHES = dict.fromkeys(("unpack_vector", "unpack_scalar", "unpack_dense_vector",
                                "unpack_dense_scalar"), 0)
_COUNT_LOCK = threading.Lock()

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def route(bs: int, planes_ptr: int, L_ptr: int | None) -> str:
    """``"vector"`` or ``"scalar"``: the kernel route for blocks of ``bs``
    values whose planes start at address ``planes_ptr`` and whose L codes
    (``None`` for :func:`unpack_dense`) start at ``L_ptr``.

    The vector route takes ``bs`` a positive multiple of 4 with the planes
    and L on 4 bytes (a lane reads a plane's four bytes and its four L
    codes as one word each; the output is a fresh allocation, aligned for
    the lane's four-value store).  Every other shape takes the scalar
    route."""
    fits = (bs >= 4 and bs % 4 == 0 and planes_ptr % 4 == 0
            and (L_ptr is None or L_ptr % 4 == 0))
    return "vector" if fits else "scalar"


def tensor_route(planes: torch.Tensor, L: torch.Tensor | None = None) -> str:
    """The route :func:`unpack` (with ``L``) or :func:`unpack_dense` (without)
    takes for these tensors on the card."""
    return route(planes.shape[-1], planes.data_ptr(), None if L is None else L.data_ptr())


def _count_launch(kind: str, which: str) -> None:
    global LAUNCHES, DENSE_LAUNCHES
    with _COUNT_LOCK:
        if kind == "unpack":
            LAUNCHES += 1
        else:
            DENSE_LAUNCHES += 1
        ROUTE_LAUNCHES[f"{kind}_{which}"] += 1


def _launch(planes, mu, shift, nbytes, L, spec: DtypeSpec) -> torch.Tensor:
    nb, W, bs = planes.shape
    dev = planes.device
    checks = (("planes", planes, torch.uint8), ("mu", mu, spec.dtype),
              ("shift", shift, torch.int32), ("nbytes", nbytes, torch.int32))
    if L is not None:
        checks += (("L", L, torch.uint8),)
    for name, t, dt in checks:
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"unpack: {name} must be contiguous {dt} on {dev}")
    if W != spec.itemsize or mu.shape != (nb,) or shift.shape != (nb,) \
            or nbytes.shape != (nb,) or (L is not None and L.shape != (nb, bs)):
        raise ValueError(f"unpack: shapes do not match planes {tuple(planes.shape)}")
    out = torch.empty((nb, bs), dtype=spec.dtype, device=dev)
    if nb and bs:                            # a grid of 0 is refused
        kind = "unpack" if L is not None else "unpack_dense"
        planes_ptr, L_ptr = planes.data_ptr(), None if L is None else L.data_ptr()
        which = route(bs, planes_ptr, L_ptr)
        fn = _build.function("unpack", f"szx_unpack_{which}", _ARGTYPES)
        args = (spec.code, planes_ptr, mu.data_ptr(), shift.data_ptr(), nbytes.data_ptr(),
                L_ptr, nb, bs, out.data_ptr())
        rc = _build.launch(fn, dev, args)
        if rc:
            raise RuntimeError(f"{kind} kernel launch failed ({which} route, CUDA error {rc})")
        _count_launch(kind, which)
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
