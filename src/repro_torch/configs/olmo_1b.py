"""OLMo-1B  [arXiv:2402.00838; hf] — dense MHA, NON-PARAMETRIC LayerNorm, SwiGLU."""
from repro_torch.configs.base import ArchConfig, register


@register("olmo-1b")
def olmo_1b() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        head_dim=128,
        norm="layernorm_np",  # elementwise_affine=False — the paper's distinguishing choice
        act="swiglu",
        rope="rope",
        rope_theta=10000.0,
        tie_embeddings=True,
    )
