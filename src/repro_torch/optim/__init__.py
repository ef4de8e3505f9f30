from repro_torch.optim.adamw import AdamW, AdamWState, global_norm, warmup_cosine  # noqa: F401
