"""Model definitions of the port (the uniform dense stack so far)."""
from repro_torch.models.model import Model, build_model
