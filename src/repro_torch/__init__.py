"""repro_torch -- the SZx codec ported to PyTorch and CUDA for the NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it.  The supported public surface is :mod:`repro_torch.api`; its names are
re-exported here (``repro_torch.SZxCodec``, ``repro_torch.Bound``, ...), the
same names as ``repro``'s.
"""

import importlib

__version__ = "1.1.0"

__all__ = [
    "api",
    "Bound",
    "SZxCodec",
    "TreeCodec",
    "PlanesCodec",
    "ArrayStore",
    "CompressedArray",
    "CheckpointManager",
    "CompressionStats",
    "compress",
    "compress_with_stats",
    "decompress",
]


def __getattr__(name):
    # Top-level names resolve through repro_torch.api lazily: `import
    # repro_torch` stays cheap (no torch), and repro_torch.api remains the one
    # definition of the surface.  import_module, not `from repro_torch import
    # api`: that form asks this hook for "api" again before the submodule
    # loads, and recurses.
    if name in __all__:
        api = importlib.import_module("repro_torch.api")
        if name == "api":
            return api
        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
