"""repro_torch.core.codec -- the SZx byte-stream codec (paper Algorithm 1 as a
stage pipeline) in PyTorch, with hand-written Hopper kernels.

Layers:
  plan       -- dtype/error-bound resolution, blocking/padding (Alg. 1 l. 1-2)
  transform  -- the fixed-shape block encoding record and its layout rule
  container  -- stream header constants, self-delimiting chunk frames, the
                container-v3 index footer
  device     -- encode and decode on the card: the fused kernels plus the
                byte layout as tensor ops; a chunk crosses the link once

Front-end:
  SZxCodec   -- byte-stream codec (monolithic + chunked streaming,
                f32/f64/f16/bf16), byte-identical to the JAX package's
  TreeCodec  -- a tree of tensors as one multi-leaf container-v3 stream,
                byte-identical to the JAX package's
  PlanesCodec -- fixed-shape szx-planes codec (P byte planes per value) for
                gradient and activation traffic, bit-identical to the JAX
                package's jax route
"""
from repro_torch.core.codec import container, device, plan, transform  # noqa: F401
from repro_torch.core.codec.device import DeviceEncoding  # noqa: F401
from repro_torch.core.codec.plan import DEFAULT_BLOCK_SIZE, Bound  # noqa: F401
from repro_torch.core.codec.planes_codec import PlanesCodec  # noqa: F401
from repro_torch.core.codec.tree import TreeCodec  # noqa: F401
from repro_torch.core.codec.szx_codec import (  # noqa: F401
    DEFAULT_CHUNK_BYTES,
    CompressionStats,
    SZxCodec,
    compress,
    compress_with_stats,
    decompress,
)
