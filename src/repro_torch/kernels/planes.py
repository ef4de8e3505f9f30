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
launch.  Each kernel has two routes, picked by :func:`route` from the block
width and the pointers' alignment alone: the vector route (a power-of-two
block of 4 or more values, float32 data on 16 bytes, planes on min(bs, 16)
bytes) and the scalar route for every other shape.  A failed launch raises
on either; nothing falls back to the other route.  The decode reads ``sexp``
as int8, int16 or int32, the widths the KV cache, the gradient wire and the
encode store it at.  Each launch is a custom operator
(``repro_torch::planes_encode``, ``::planes_decode``) whose fake
implementation gives the outputs' shapes only; every CUDA tensor goes
through it, so a fake tensor (the dry-run's) reaches no launch.
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
# the same launches by route ("encode_vector", "encode_scalar", "decode_vector",
# "decode_scalar")
ROUTE_LAUNCHES = dict.fromkeys(("encode_vector", "encode_scalar", "decode_vector",
                                "decode_scalar"), 0)
_COUNT_LOCK = threading.Lock()
SEXP_DTYPES = (torch.int8, torch.int16, torch.int32)   # what the decode kernel reads

_ENCODE_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p]
_DECODE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]


def route(bs: int, values_ptr: int, planes_ptr: int) -> str:
    """``"vector"`` or ``"scalar"``: the kernel route for blocks of ``bs``
    values whose float32 data (the encode's input, the decode's output)
    starts at address ``values_ptr`` and whose planes start at ``planes_ptr``.

    The vector route takes a power-of-two ``bs`` of 4 or more (a lane owns
    min(bs, 16) values, a block is a power-of-two group of lanes, or the
    whole warp in chunks of 512), float32 data on 16 bytes (float4 accesses)
    and planes on min(bs, 16) bytes (one store of a lane's bytes of a
    plane).  Every other shape takes the scalar route."""
    vec = min(bs, 16)
    fits = (bs >= 4 and bs & (bs - 1) == 0 and values_ptr % 16 == 0
            and planes_ptr % vec == 0)
    return "vector" if fits else "scalar"


def encode_route(xb: torch.Tensor) -> str:
    """The route :func:`planes_encode` takes for ``xb`` on the card (its
    planes are a fresh allocation, aligned)."""
    return route(xb.shape[-1], _blocks(xb).data_ptr(), 0)


def decode_route(planes: torch.Tensor) -> str:
    """The route :func:`planes_decode` takes for ``planes`` on the card (its
    output is a fresh allocation, aligned)."""
    return route(planes.shape[-1], 0, _plane_blocks(planes).data_ptr())


def _blocks(xb: torch.Tensor) -> torch.Tensor:
    return xb.reshape(-1, xb.shape[-1]).contiguous()


def _plane_blocks(planes: torch.Tensor) -> torch.Tensor:
    return planes.reshape(planes.shape[0], -1, planes.shape[-1]).contiguous()


def _count_launch(kind: str, which: str) -> None:
    global ENCODE_LAUNCHES, DECODE_LAUNCHES
    with _COUNT_LOCK:
        if kind == "decode":
            DECODE_LAUNCHES += 1
        else:
            ENCODE_LAUNCHES += 1
        ROUTE_LAUNCHES[f"{kind}_{which}"] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")


def _launch(name: str, symbol: str, argtypes, dev: torch.device, *args) -> None:
    fn = _build.function("planes", symbol, argtypes)
    rc = _build.launch(fn, dev, args)
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
    return _encode_op(xb, num_planes)


@torch.library.custom_op("repro_torch::planes_encode", mutates_args=(), device_types="cuda")
def _encode_op(xb: torch.Tensor, num_planes: int) -> tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    lead, bs = tuple(xb.shape[:-1]), xb.shape[-1]
    x2 = _blocks(xb)
    nb = x2.shape[0]
    dev = xb.device
    mu = torch.empty(nb, dtype=torch.float32, device=dev)
    sexp = torch.empty(nb, dtype=torch.int32, device=dev)
    planes = torch.empty((num_planes, nb, bs), dtype=torch.uint8, device=dev)
    if nb and bs:                            # a grid of 0 is refused
        tab = ref.planes_scale_table(dev)
        which = route(bs, x2.data_ptr(), planes.data_ptr())
        _launch("planes_encode", f"szx_planes_encode_{which}", _ENCODE_ARGTYPES, dev,
                x2.data_ptr(), nb, bs, num_planes, tab.data_ptr(), mu.data_ptr(),
                sexp.data_ptr(), planes.data_ptr())
        _count_launch("encode", which)
    return (mu.reshape(lead), sexp.reshape(lead),
            planes.reshape((num_planes,) + lead + (bs,)))


@_encode_op.register_fake
def _encode_shape(xb, num_planes):
    lead = tuple(xb.shape[:-1])
    return (xb.new_empty(lead, dtype=torch.float32), xb.new_empty(lead, dtype=torch.int32),
            xb.new_empty((num_planes,) + tuple(xb.shape), dtype=torch.uint8))


def planes_decode(mu: torch.Tensor, sexp: torch.Tensor, planes: torch.Tensor):
    """Inverse of :func:`planes_encode` -> (..., bs) float32; sexp int8,
    int16 or int32, read at its width."""
    num_planes = planes.shape[0]
    if not 1 <= num_planes <= 3:
        raise ValueError("szx-planes supports 1..3 byte planes")
    if planes.device.type == "cpu":
        return planes_decode_plain(mu, sexp, planes)
    _check("planes_decode", planes, torch.uint8)
    _check("planes_decode", mu, torch.float32)
    if sexp.dtype not in SEXP_DTYPES:
        raise ValueError(f"planes_decode: sexp must be int8, int16 or int32, got {sexp.dtype}")
    _check("planes_decode", sexp, sexp.dtype)
    return _decode_op(mu, sexp, planes)


@torch.library.custom_op("repro_torch::planes_decode", mutates_args=(), device_types="cuda")
def _decode_op(mu: torch.Tensor, sexp: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    num_planes = planes.shape[0]
    lead, bs = tuple(planes.shape[1:-1]), planes.shape[-1]
    p2 = _plane_blocks(planes)
    nb = p2.shape[1]
    if mu.numel() != nb or sexp.numel() != nb:
        raise ValueError(f"planes_decode: {nb} blocks but mu {tuple(mu.shape)}, "
                         f"sexp {tuple(sexp.shape)}")
    mu1, sexp1 = mu.reshape(-1).contiguous(), sexp.reshape(-1).contiguous()
    dev = planes.device
    out = torch.empty((nb, bs), dtype=torch.float32, device=dev)
    if nb and bs:
        tab = ref.planes_scale_table(dev)
        which = route(bs, out.data_ptr(), p2.data_ptr())
        _launch("planes_decode", f"szx_planes_decode_{which}", _DECODE_ARGTYPES, dev,
                mu1.data_ptr(), sexp1.data_ptr(), sexp1.element_size(), p2.data_ptr(), nb,
                bs, num_planes, tab.data_ptr(), out.data_ptr())
        _count_launch("decode", which)
    return out.reshape(lead + (bs,))


@_decode_op.register_fake
def _decode_shape(mu, sexp, planes):
    return planes.new_empty(tuple(planes.shape[1:]), dtype=torch.float32)
