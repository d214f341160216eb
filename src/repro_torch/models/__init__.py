"""Model definitions of the port: the uniform stack (dense, MoE, vision), the
jamba and xLSTM stacks and the encoder-decoder, behind one ``Model`` API."""
from repro_torch.models.model import Model, build_model, input_specs
