"""repro_torch.store -- block-addressable compressed N-d array store on torch.

A zarr-like on-disk store over the SZx codec, byte-identical to the JAX
package's: ``ArrayStore.save`` writes an N-d array as a grid of
independently addressable compressed chunks (a container-v3 stream whose
footer is the block-grid index), and ``ArrayStore.open`` returns a lazy
:class:`CompressedArray` supporting

* **ROI reads** -- ``ca[10:20, :, 5]`` decodes, on the card, only the chunks
  and SZx blocks intersecting the request (bytes read scale with the ROI,
  not the array), and
* **compressed-domain queries** -- ``ca.mean()/min()/max()/sum()`` answered
  from block headers wherever blocks are constant, decoding only what is
  not (``repro_torch.store.query``).

CLI: ``python -m repro_torch.store {create,info,read,query,serve}``.
"""
from repro_torch.store.array import ArrayStore, CompressedArray  # noqa: F401
from repro_torch.store.grid import ChunkGrid  # noqa: F401
from repro_torch.store.query import QueryStats  # noqa: F401

save = ArrayStore.save
open = ArrayStore.open  # noqa: A001 - mirrors zarr's module-level open()
