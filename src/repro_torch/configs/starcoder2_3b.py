"""StarCoder2-3B  [arXiv:2402.19173; hf]  — dense, GQA kv=2, RoPE, LayerNorm+bias GELU."""
from repro_torch.configs.base import ArchConfig, register


@register("starcoder2-3b")
def starcoder2_3b() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        head_dim=128,
        norm="layernorm",
        act="gelu",
        qkv_bias=True,
        mlp_bias=True,
        rope="rope",
        rope_theta=100000.0,
        tie_embeddings=True,
    )
