"""xLSTM-1.3B  [arXiv:2405.04517; unverified] — attention-free sLSTM + mLSTM blocks.

48 residual blocks, d_model 2048, 4 heads. d_ff=0: xLSTM blocks carry their own
up/down projections (pre-up-projection mLSTM), no separate FFN sublayer.
Attention-free => O(1)-state decode.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("xlstm-1.3b")
def xlstm_1_3b() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        head_dim=512,
        norm="layernorm",
        act="gelu",
        rope="none",
        tie_embeddings=True,
        ssm=SSMConfig(kind="xlstm", slstm_every=8),  # xLSTM[7:1] block ratio
    )
