"""Qwen2-VL-2B  [arXiv:2409.12191; hf] — VLM backbone with M-RoPE.

The vision patch frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings merged at prefix positions. The backbone implements
M-RoPE (3D rotary sections over temporal/height/width position ids).
"""
from repro_torch.configs.base import ArchConfig, register


@register("qwen2-vl-2b")
def qwen2_vl_2b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        head_dim=128,
        norm="rmsnorm",
        act="swiglu",
        qkv_bias=True,
        rope="mrope",
        rope_theta=1000000.0,
        tie_embeddings=True,
        frontend="vision",
    )
