"""Architecture registry of the port. Importing this package registers the
JAX package's ten architectures: the uniform stack (dense, MoE and vision)
of ``llama3.2-3b``, ``olmo-1b``, ``qwen2.5-32b``, ``starcoder2-3b``,
``kimi-k2-1t-a32b``, ``arctic-480b`` and ``qwen2-vl-2b``, the mLSTM + sLSTM
stack of ``xlstm-1.3b``, the Mamba + attention + MoE stack of
``jamba-1.5-large-398b`` and the encoder-decoder of ``whisper-medium``, and
exports the dry run's shape suite (``SHAPES``)."""
from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    SUBQUADRATIC_FAMILIES,
    TRAIN_4K,
    ArchConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    all_cells,
    get_config,
    list_archs,
    register,
)

from repro_torch.configs import (
    arctic_480b, jamba_1_5_large_398b, kimi_k2_1t_a32b, llama3_2_3b, olmo_1b, qwen2_5_32b,
    qwen2_vl_2b, starcoder2_3b, whisper_medium, xlstm_1_3b,
)
