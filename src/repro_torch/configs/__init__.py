"""Architecture registry of the port. Importing this package registers the
architectures ported so far (the uniform dense stack of ``llama3.2-3b``)."""
from repro_torch.configs.base import (
    ArchConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
)

from repro_torch.configs import llama3_2_3b
