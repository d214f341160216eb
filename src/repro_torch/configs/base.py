"""Architecture configuration: a copy of ``repro.configs.base``'s dataclasses.

The port keeps its own copy instead of importing the JAX package, so that
nothing under ``repro_torch`` imports ``repro``. A test holds every registered
config here equal, field by field, to the JAX package's.

Only the fields and helpers the ported path reads are kept: the geometry, the
``reduced()`` cut used by the CPU tests, and the registry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    first_k_dense: int = 0
    dense_residual: bool = False
    d_ff_dense: int = 0
    moe_every: int = 1
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    attn_every: int = 0
    slstm_every: int = 0


@dataclass(frozen=True)
class ArchConfig:
    """Complete static description of one architecture."""

    name: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // n_heads

    norm: str = "rmsnorm"              # rmsnorm | layernorm | layernorm_np
    act: str = "swiglu"                # swiglu | gelu | geglu
    qkv_bias: bool = False
    mlp_bias: bool = False
    rope: str = "rope"                 # rope | mrope | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0

    frontend: str = "none"

    dtype: str = "bfloat16"
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU tests (same cut as the JAX package)."""
        kw: Dict = {}
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=64,
                d_ff_dense=64 if self.moe.d_ff_dense else 0,
                first_k_dense=min(self.moe.first_k_dense, 1),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm,
                d_state=8,
                attn_every=min(self.ssm.attn_every, 4) if self.ssm.attn_every else 0,
                slstm_every=min(self.ssm.slstm_every, 2) if self.ssm.slstm_every else 0,
            )
        n_layers = 8 if (self.ssm and self.ssm.attn_every) else 2
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_encoder_layers=2 if self.enc_dec else 0,
            encoder_seq=16 if self.enc_dec else 0,
            remat="none",
            **kw,
        )


_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _c  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
