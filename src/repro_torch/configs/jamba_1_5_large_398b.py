"""Jamba-1.5-Large 398B  [arXiv:2403.19887; hf] — Mamba+attention 1:7 hybrid with MoE.

72 layers = 9 periods of 8 (7 Mamba + 1 attention). MoE (16 experts, top-2) replaces
the MLP in every other layer. Sub-quadratic (Mamba state + only 9 attention layers)
=> runs the long_500k cell with a sequence-sharded KV cache.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register


@register("jamba-1.5-large-398b")
def jamba_1_5_large_398b() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        rope="none",               # Jamba uses no positional encoding (Mamba provides order)
        tie_embeddings=False,
        moe=MoEConfig(
            n_experts=16,
            top_k=2,
            d_ff_expert=24576,
            moe_every=2,           # MoE every other layer; dense MLP otherwise
            d_ff_dense=24576,
            router_aux_weight=0.01,
        ),
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2, attn_every=8),
    )
