"""Build and load the CUDA kernels in ``repro_torch/csrc`` (no torch headers).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries land in
``src/repro_torch/_build/`` under a name that carries a digest of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the cached file.  Nothing here runs at import: the first launch builds.

Flags: ``sm_90a`` (Hopper); ``--fmad=false`` because the codec's float steps
must round exactly as numpy does (a fused multiply-add rounds once where the
reference rounds twice); no ``--use_fast_math``, which would flush the
subnormals the exponent rule relies on.  ``flash_attention``, held to a
tolerance, writes its products as explicit ``__fmaf_rn``.  ``-Xptxas -v``
makes each build report its kernels' registers, shared memory and spills;
:data:`LOGS` keeps that output per source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("encode", "decode", "bitshuffle", "unpack", "planes", "flash_attention",
           "block_stats", "pack")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}
LOGS: dict[str, str] = {}          # source -> the compiler's output of its last build


def nvcc() -> str:
    """Path of the CUDA compiler: ``$NVCC``, ``nvcc`` on PATH, or the
    toolkit's default location."""
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or put the CUDA toolkit's bin on PATH); "
        "the repro_torch CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # a shared header edit rebuilds all
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library among ``names``, one ``nvcc`` per
    source, all started together.  Returns seconds per source built (empty
    when all were cached); raises with the compiler's output on failure."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> dict[str, float]:
    todo = [(n, out) for n in names if not (out := library_path(n)).is_file()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    secs, errors = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode:
            errors.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            LOGS[name] = log
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` as a ctypes
    function returning int, building and loading the library at first use
    (under the build lock; a loaded function is read without it)."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is not None:
        return fn
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            lib = _LIBS.get(name)
            if lib is None:
                _build_locked([name])
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
    return fn


def launch(fn, dev, args) -> int:
    """``fn(*args, stream)`` with the raw handle of card ``dev``'s current
    stream, making ``dev`` the current card only when it is not already;
    returns the C entry point's code.  Every wrapper in ``kernels/``
    launches through it.  (``torch.cuda.current_stream(dev)`` builds a
    Stream object a call; the raw handle is the same stream.)"""
    import torch

    index = dev.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
