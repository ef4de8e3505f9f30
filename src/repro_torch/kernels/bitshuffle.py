"""Bit transpose of byte tiles (the second stage's shuffle): CUDA kernel and
its plain version.

The kernel is ``csrc/bitshuffle.cu`` (Hopper, ``sm_90a``), which replaces the
Pallas TPU kernel ``repro/kernels/bitshuffle.py::bitshuffle``.  The plain
version is :func:`repro_torch.kernels.ref.bitshuffle_ref`.
:func:`bitshuffle` takes the plain version for a CPU tensor only; a CUDA
tensor launches the kernel or raises.  Forward and inverse launches are
counted apart, so a run can show that both directions ran, and by route:
:func:`route` picks the vector route (64-bit words, 8x8 bit transposes)
for tiles on 16 bytes and the scalar route (a byte a thread) for any other
pointer.  Nothing falls back from one route to the other.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build, ref, specs
from repro_torch.kernels.specs import DtypeSpec

bitshuffle_plain = ref.bitshuffle_ref

LAUNCHES = 0          # forward kernel launches since the last reset
INVERSE_LAUNCHES = 0  # inverse kernel launches since the last reset
# the same launches by route ("bitshuffle_vector", "bitshuffle_scalar",
# "bitshuffle_inverse_vector", "bitshuffle_inverse_scalar")
ROUTE_LAUNCHES = dict.fromkeys(("bitshuffle_vector", "bitshuffle_scalar",
                                "bitshuffle_inverse_vector", "bitshuffle_inverse_scalar"), 0)
_COUNT_LOCK = threading.Lock()

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]


def route(in_ptr: int) -> str:
    """``"vector"`` or ``"scalar"``: the kernel route for tiles that start at
    address ``in_ptr`` (the output is a fresh allocation, aligned).  The
    vector route reads and writes 16 bytes a thread at a time, so it takes
    tiles on 16 bytes (every tile width is a multiple of 64 bytes, so each
    tile is then aligned too); any other pointer takes the scalar route."""
    return "vector" if in_ptr % 16 == 0 else "scalar"


def _count_launch(inverse: bool, which: str) -> None:
    global LAUNCHES, INVERSE_LAUNCHES
    with _COUNT_LOCK:
        if inverse:
            INVERSE_LAUNCHES += 1
        else:
            LAUNCHES += 1
        ROUTE_LAUNCHES[f"bitshuffle{'_inverse' if inverse else ''}_{which}"] += 1


def bitshuffle(tiles: torch.Tensor, *, spec: DtypeSpec = specs.F32,
               inverse: bool = False) -> torch.Tensor:
    """Bit-transpose (nt, tile_bytes(spec)) uint8 tiles -> a new tensor of
    the same shape; ``inverse=True`` runs the exact inverse."""
    T = specs.tile_bytes(spec)
    if tiles.dim() != 2 or tiles.shape[1] != T:
        raise ValueError(
            f"bitshuffle tile width {tiles.shape[-1] if tiles.dim() else None} != "
            f"tile_bytes({spec.name}) = {T}"
        )
    if tiles.dtype != torch.uint8:
        raise ValueError(f"bitshuffle: expected uint8 tiles, got {tiles.dtype}")
    if tiles.device.type == "cpu":
        return bitshuffle_plain(tiles, inverse)
    if tiles.device.type != "cuda":
        raise ValueError(f"bitshuffle: unsupported device {tiles.device}")
    tiles = tiles.contiguous()
    nt = tiles.shape[0]
    out = torch.empty_like(tiles)
    if nt:                                   # a grid of 0 is refused
        which = route(tiles.data_ptr())
        fn = _build.function("bitshuffle", f"szx_bitshuffle_{which}", _ARGTYPES)
        rc = _build.launch(fn, tiles.device, (tiles.data_ptr(), out.data_ptr(), nt, T,
                                              int(inverse)))
        if rc:
            raise RuntimeError(f"bitshuffle kernel launch failed ({which} route, CUDA error {rc})")
        _count_launch(inverse, which)
    return out
