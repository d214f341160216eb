"""Snowflake Arctic 480B  [hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: a dense residual MLP runs in PARALLEL with a 128-expert top-2 MoE
in every layer (Arctic's signature layout).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("arctic-480b")
def arctic_480b() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab_size=32000,
        head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        rope="rope",
        rope_theta=10000.0,
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=128,
            top_k=2,
            d_ff_expert=4864,
            dense_residual=True,
            d_ff_dense=4864,
            router_aux_weight=0.01,
        ),
    )
