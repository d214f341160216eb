from repro_torch.checkpoint.checkpoint import CheckpointManager  # noqa: F401
