"""Flash-attention forward: the CUDA kernel and its plain version.

The kernel is ``csrc/flash_attention.cu`` (Hopper, ``sm_90a``), which
replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_fwd``.  The plain version
is :func:`repro_torch.kernels.ref.flash_attention_ref`, the online softmax of
``repro/models/layers.py::flash_attention``.  The wrapper takes the plain
version for a CPU tensor only; a CUDA tensor launches the kernel or raises.
The kernel is held to the plain version to a tolerance (its sums run in
another order), not bit for bit.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.kernels import _build, ref

flash_attention_plain = ref.flash_attention_ref

LAUNCHES = 0          # flash_attention() kernel launches since the last reset
_COUNT_LOCK = threading.Lock()
MAX_HEAD_DIM = 128
MAX_GROUP = 64        # query heads per kv head: a block holds 64 (position, head) rows
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]


def _count_launch() -> None:
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; the kernel takes "
                             "float32 or bfloat16, the same for q, k and v")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, hd), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    b, _sq, hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit")
    hkv = k.shape[2]
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}")
    if hkv == 0 or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} kv heads (the group "
                         f"must divide evenly, at most {MAX_GROUP})")
    if b * hkv > 65535:
        raise ValueError(f"flash_attention: batch x kv heads {b * hkv} > 65535")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention forward: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd) ->
    (B, Sq, Hq, hd) in q.dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v)
    b, sq, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or sq == 0:                    # a grid of 0 is refused
        return out
    fn = _build.function("flash_attention", "szx_flash_attention_fwd", _ARGTYPES)
    dev = q.device
    with torch.cuda.device(dev):
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, sq, skv, hq, hkv, hd, int(bool(causal)), int(window),
                1.0 / math.sqrt(hd), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed (CUDA error {rc})")
    _count_launch()
    return out
