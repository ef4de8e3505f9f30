"""repro_torch.api -- the public surface of the PyTorch port.

  Bound        -- the unified error-bound spec: ``Bound.abs(1e-3)`` /
                  ``Bound.rel(1e-4)``; every bound-taking API also accepts a
                  bare float, meaning ``Bound.abs``
  SZxCodec     -- byte-stream codec (monolithic + chunked streaming,
                  f32/f64/f16/bf16) on the card, streams byte-identical to
                  the JAX package's
  compress / decompress / compress_with_stats -- one-shot functional API
"""
from repro_torch.core.codec.plan import Bound  # noqa: F401
from repro_torch.core.codec.szx_codec import (  # noqa: F401
    CompressionStats,
    SZxCodec,
    compress,
    compress_with_stats,
    decompress,
)

__all__ = [
    "Bound",
    "SZxCodec",
    "CompressionStats",
    "compress",
    "compress_with_stats",
    "decompress",
]
