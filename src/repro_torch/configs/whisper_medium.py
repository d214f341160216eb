"""Whisper-medium  [arXiv:2212.04356; unverified] — enc-dec audio backbone.

The conv frontend is a STUB per the assignment: ``input_specs()`` provides 1500
precomputed frame embeddings (30 s of audio after the 2x-strided conv stem); the
transformer backbone (24 encoder + 24 decoder layers) is fully implemented, including
cross-attention and a decoder KV cache for the decode shapes.
"""
from repro_torch.configs.base import ArchConfig, register


@register("whisper-medium")
def whisper_medium() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium",
        family="audio",
        n_layers=24,               # decoder layers
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        head_dim=64,
        norm="layernorm",
        act="gelu",
        qkv_bias=True,
        mlp_bias=True,
        rope="none",               # whisper uses learned/sinusoidal positions
        tie_embeddings=True,
        enc_dec=True,
        n_encoder_layers=24,
        encoder_seq=1500,
        frontend="audio",
    )
