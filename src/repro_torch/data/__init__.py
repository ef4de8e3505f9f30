"""Data substrate: synthetic pipelines, the SZx-compressed in-memory cache,
store-backed streaming ingest and synthetic scientific fields."""
from repro_torch.data.pipeline import (  # noqa: F401
    CompressedInMemoryCache,
    DataConfig,
    Prefetcher,
    SyntheticLM,
)
from repro_torch.data.store_loader import (  # noqa: F401
    PipelinedBatches,
    SteppedBatches,
    StoreLM,
    StoreLoader,
    WindowSampler,
    window_for_values,
)
