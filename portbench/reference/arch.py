"""A configuration file's architecture, read from its published keys alone."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Arch:
    """The shapes and the block of a dense pre-norm decoder."""

    d: int                  # hidden size
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ff: int                 # MLP width
    vocab: int              # embedding rows
    layers: int
    gated: bool             # SwiGLU (gate, up, down) or GELU (up, down)
    bias: bool              # biases on q, k, v, o and the MLP
    norm_affine: bool       # LayerNorm with scale and bias, or none (OLMo)
    norm_eps: float
    rope_theta: float
    tied: bool


def arch_of(cfg: dict) -> Arch:
    """``cfg`` is a file of ``configs/``: Hugging Face keys of an ``olmo`` or
    ``starcoder2`` config."""
    kind = cfg["model_type"]
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    common = dict(d=d, n_heads=heads, n_kv_heads=cfg["num_key_value_heads"],
                  head_dim=d // heads, ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                  layers=cfg["num_hidden_layers"], rope_theta=float(cfg["rope_theta"]),
                  tied=bool(cfg["tie_word_embeddings"]))
    if kind == "olmo":
        if cfg["hidden_act"] != "silu" or cfg["attention_bias"] or cfg.get("clip_qkv"):
            raise ValueError(f"{cfg['name']}: an OLMo variant this reference does not cover")
        return Arch(gated=True, bias=False, norm_affine=False, norm_eps=1e-5, **common)
    if kind == "starcoder2":
        if cfg["hidden_act"] != "gelu_pytorch_tanh" or cfg["norm_type"] != "layer_norm":
            raise ValueError(f"{cfg['name']}: a StarCoder2 variant this reference does not cover")
        return Arch(gated=False, bias=bool(cfg["use_bias"]), norm_affine=True,
                    norm_eps=float(cfg["norm_epsilon"]), **common)
    raise ValueError(f"{cfg['name']}: no reference for model_type {kind!r}")


def param_count(a: Arch) -> int:
    """Parameters of the image, biases and norms included."""
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    attn = a.d * q + 2 * a.d * kv + q * a.d + ((q + 2 * kv + a.d) if a.bias else 0)
    mlp = (3 if a.gated else 2) * a.d * a.ff + ((a.ff + a.d) if a.bias else 0)
    norms = 4 * a.d if a.norm_affine else 0
    embed = a.vocab * a.d * (1 if a.tied else 2)
    return a.layers * (attn + mlp + norms) + embed + (2 * a.d if a.norm_affine else 0)
