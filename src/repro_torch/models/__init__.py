"""Model definitions of the port (the uniform dense, jamba and xLSTM stacks so far)."""
from repro_torch.models.model import Model, build_model
