from repro_torch.data.pipeline import (  # noqa: F401
    CompressedInMemoryCache,
    DataConfig,
    Prefetcher,
    SyntheticLM,
)
