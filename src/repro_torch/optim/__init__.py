from repro_torch.optim.adamw import AdamW, AdamWConfig, cosine_schedule  # noqa: F401
