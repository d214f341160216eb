"""Kimi-K2 1T-A32B  [arXiv:2501.kimi2; unverified] — trillion-param MoE (paper-table).

384 experts, top-8 routing, 1 shared expert, first layer dense (DeepSeek-V3-style
recipe the K2 report builds on). Expert width 2048, dense-layer width 18432.
Total ~1.02T params, ~32B active per token.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2_1t_a32b() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,                 # expert width (assignment spec)
        vocab_size=163840,
        head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        rope="rope",
        rope_theta=50000.0,
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_ff_expert=2048,
            n_shared_experts=1,
            first_k_dense=1,
            d_ff_dense=18432,
            router_aux_weight=0.001,  # K2/DSv3 run near-aux-free; keep a small weight
        ),
    )
