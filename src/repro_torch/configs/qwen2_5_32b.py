"""Qwen2.5-32B  [hf:Qwen/Qwen2.5-32B; hf] — dense, GQA kv=8, QKV bias, 152k vocab."""
from repro_torch.configs.base import ArchConfig, register


@register("qwen2.5-32b")
def qwen2_5_32b() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        qkv_bias=True,
        rope="rope",
        rope_theta=1000000.0,
        tie_embeddings=False,
    )
