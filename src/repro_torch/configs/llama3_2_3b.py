"""Llama-3.2-3B  [hf:meta-llama/Llama-3.2-3B; unverified] — dense, GQA kv=8, SwiGLU."""
from repro_torch.configs.base import ArchConfig, register


@register("llama3.2-3b")
def llama3_2_3b() -> ArchConfig:
    return ArchConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        rope="rope",
        rope_theta=500000.0,
        tie_embeddings=True,
    )
