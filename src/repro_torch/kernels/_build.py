"""Build and load the CUDA kernels in ``repro_torch/csrc`` (no torch headers).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries land in
``src/repro_torch/_build/`` under a name that carries a digest of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the cached file.  Nothing here runs at import: the first launch builds.

Flags: ``sm_90a`` (Hopper); ``--fmad=false`` because the codec's float steps
must round exactly as numpy does (a fused multiply-add rounds once where the
reference rounds twice); no ``--use_fast_math``, which would flush the
subnormals the exponent rule relies on.
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
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
SOURCES = ("encode", "decode")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}


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
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` as a ctypes
    function returning int, building and loading the library at first use."""
    key = (name, symbol)
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
