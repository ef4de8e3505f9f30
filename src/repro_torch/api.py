"""repro_torch.api -- the public surface of the PyTorch port.

  Bound        -- the unified error-bound spec: ``Bound.abs(1e-3)`` /
                  ``Bound.rel(1e-4)``; every bound-taking API also accepts a
                  bare float, meaning ``Bound.abs``
  SZxCodec     -- byte-stream codec (monolithic + chunked streaming,
                  f32/f64/f16/bf16) on the card, streams byte-identical to
                  the JAX package's
  compress / decompress / compress_with_stats -- one-shot functional API
  PlanesCodec  -- fixed-shape szx-planes codec (gradient and activation
                  traffic; ``repro_torch.core.grad_compress`` runs on it)
  ArrayStore   -- block-addressable compressed N-d array store: ``save`` /
                  ``save_sharded`` / ``open`` -> lazy ``CompressedArray`` with
                  ROI reads and compressed-domain queries on the card
  CompressedArray -- that lazy view (also ``CheckpointManager.leaf_store``'s
                  view of one checkpoint leaf)
  TreeCodec    -- nested dicts / lists / NamedTuples of tensors as one
                  multi-leaf container-v3 stream (leaves encoded on the card)
  CheckpointManager -- atomic, keep-k, optionally SZx-compressed checkpoints
                  of trees, byte-identical to the JAX package's
  StoreLoader  -- streaming training ingest: pipelined shuffled-ROI-window
                  batches over an ArrayStore (file, shard manifest or
                  service URL) on the card, bytes read proportional to the
                  batch
  StoreLM      -- StoreLoader windows quantized into LM tokens (the train
                  launcher's ``--data-store``)
  RemoteStore  -- stdlib HTTP client for the store service (remote ROI reads
                  as tensors on the card), for a server of either package
  block_stats / pack -- the two-call SZx encode (``ops.block_stats``,
                  ``ops.pack``) whose halves the fused encode runs in one pass
"""
from repro_torch.core.codec.plan import Bound  # noqa: F401
from repro_torch.core.codec.planes_codec import PlanesCodec  # noqa: F401
from repro_torch.core.codec.szx_codec import (  # noqa: F401
    CompressionStats,
    SZxCodec,
    compress,
    compress_with_stats,
    decompress,
)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.core.codec.tree import TreeCodec  # noqa: F401
from repro_torch.data.store_loader import StoreLM, StoreLoader  # noqa: F401
from repro_torch.kernels.ops import block_stats, pack  # noqa: F401
from repro_torch.serve.client import RemoteStore  # noqa: F401
from repro_torch.store import ArrayStore, CompressedArray  # noqa: F401

__all__ = [
    "ArrayStore",
    "Bound",
    "CheckpointManager",
    "CompressedArray",
    "RemoteStore",
    "StoreLoader",
    "StoreLM",
    "TreeCodec",
    "block_stats",
    "pack",
    "PlanesCodec",
    "SZxCodec",
    "CompressionStats",
    "compress",
    "compress_with_stats",
    "decompress",
]
