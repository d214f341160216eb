"""Architecture registry of the port. Importing this package registers the
architectures ported so far: the uniform dense stack of ``llama3.2-3b``,
the mLSTM + sLSTM stack of ``xlstm-1.3b`` and the Mamba + attention + MoE
stack of ``jamba-1.5-large-398b``."""
from repro_torch.configs.base import (
    ArchConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
)

from repro_torch.configs import jamba_1_5_large_398b, llama3_2_3b, xlstm_1_3b
