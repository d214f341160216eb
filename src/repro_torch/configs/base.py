"""Architecture configuration: a copy of ``repro.configs.base``'s dataclasses.

The port keeps its own copy instead of importing the JAX package, so that
nothing under ``repro_torch`` imports ``repro``. A test holds every registered
config here equal, field by field, to the JAX package's.

Only the fields and helpers the ported path reads are kept: the geometry,
the shape suite of the dry run (``ShapeSpec``, ``SHAPES``, ``shape_names``,
``skipped_shapes``), the exact parameter counts and layer types its cost
model reads, the ``reduced()`` cut used by the CPU tests, and the registry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell's input geometry.

    ``kind`` selects which step gets lowered:
      * ``train``   -> ``train_step``  (tokens + labels, full seq_len)
      * ``prefill`` -> ``prefill_step`` (tokens, builds a KV cache)
      * ``decode``  -> ``decode_step`` (1 new token against a seq_len-deep cache)
    """

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES: Dict[str, ShapeSpec] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

# Families with sub-quadratic sequence mixing (may run long_500k).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


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

    def shape_names(self) -> List[str]:
        """The shape suite this arch participates in (assignment rules)."""
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.family in SUBQUADRATIC_FAMILIES:
            names.append("long_500k")
        return names

    def skipped_shapes(self) -> Dict[str, str]:
        """Shape -> reason, for cells the assignment says to skip."""
        if self.family in SUBQUADRATIC_FAMILIES:
            return {}
        return {
            "long_500k": (
                "pure full-attention architecture: 524288-token dense KV decode is "
                "excluded by the assignment (needs sub-quadratic attention)"
            )
        }

    # Parameter counting (exact, used by roofline MODEL_FLOPS = 6*N*D).
    def param_counts(self) -> Dict[str, int]:
        """Returns dict with 'total' and 'active' (per-token) parameter counts."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd

        def ffn_params(width: int) -> int:
            if width == 0:
                return 0
            if self.act in ("swiglu", "geglu"):
                return 3 * d * width
            return 2 * d * width

        def norm_params() -> int:
            if self.norm == "layernorm_np":
                return 0
            per = d if self.norm == "rmsnorm" else 2 * d
            return 2 * per  # two norms per block

        def mamba_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            dt_rank = max(d // 16, 8)
            return (
                d * (2 * d_in)                     # in_proj (x and z branches)
                + d_in * s.d_conv + d_in           # depthwise conv + bias
                + d_in * (dt_rank + 2 * s.d_state) # x_proj (dt, B, C)
                + dt_rank * d_in + d_in            # dt_proj + bias
                + d_in * s.d_state                 # A (log) matrix
                + d_in                             # D skip
                + d_in * d                         # out_proj
            )

        def mlstm_params() -> int:
            # matches repro_torch.models.ssm.mlstm_specs: up+z (4d^2), q+k (4d^2),
            # down (2d^2), conv4 + gates + head norm
            d_in = 2 * d
            return (2 * d * d_in + 2 * d_in * d + d_in * d
                    + 4 * d_in + d_in + 2 * d_in * self.n_heads
                    + self.n_heads + d_in)

        def slstm_params() -> int:
            dh = d // self.n_heads
            return (d * 4 * d + 4 * d                 # w_in + bias
                    + self.n_heads * dh * 4 * dh      # block-diag recurrent R
                    + d + d * d)                      # head norm + w_out

        total = 0
        active = 0
        L = self.n_layers
        for layer in range(L):
            lt = self.layer_type(layer)
            if lt in ("attn", "enc_attn"):
                total += attn + norm_params()
                active += attn + norm_params()
            elif lt == "mamba":
                total += mamba_params() + norm_params()
                active += mamba_params() + norm_params()
            elif lt == "mlstm":
                total += mlstm_params() + norm_params()
                active += mlstm_params() + norm_params()
            elif lt == "slstm":
                total += slstm_params() + norm_params()
                active += slstm_params() + norm_params()

            # FFN / MoE sublayer
            if lt in ("attn", "enc_attn", "mamba", "mlstm", "slstm"):
                m = self.moe
                if m is None:
                    total += ffn_params(self.d_ff)
                    active += ffn_params(self.d_ff)
                else:
                    if layer < m.first_k_dense or (m.moe_every > 1 and layer % m.moe_every != (m.moe_every - 1)):
                        width = m.d_ff_dense or self.d_ff
                        total += ffn_params(width)
                        active += ffn_params(width)
                    else:
                        router = d * m.n_experts
                        expert = ffn_params(m.d_ff_expert)
                        total += router + m.n_experts * expert
                        active += router + (m.top_k + m.n_shared_experts) * expert
                        total += m.n_shared_experts * expert
                        if m.dense_residual:
                            width = m.d_ff_dense or self.d_ff
                            total += ffn_params(width)
                            active += ffn_params(width)

        if self.enc_dec:
            # encoder self-attn + ffn, decoder adds cross-attention per layer
            enc = self.n_encoder_layers * (attn + ffn_params(self.d_ff) + norm_params())
            cross = L * (attn + (d if self.norm == "rmsnorm" else 2 * d))
            total += enc + cross
            active += enc + cross

        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        return {"total": int(total), "active": int(active)}

    def layer_type(self, layer: int) -> str:
        """What the sequence-mixing sublayer of ``layer`` is."""
        if self.ssm is None:
            return "attn"
        if self.ssm.kind == "mamba":
            if self.ssm.attn_every and layer % self.ssm.attn_every == (self.ssm.attn_every - 1):
                return "attn"
            return "mamba"
        if self.ssm.kind == "xlstm":
            if self.ssm.slstm_every and layer % self.ssm.slstm_every == (self.ssm.slstm_every - 1):
                return "slstm"
            return "mlstm"
        raise ValueError(self.ssm.kind)

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


def all_cells() -> List[Tuple[str, str]]:
    """Every runnable (arch, shape) cell in the assignment."""
    cells = []
    for arch in list_archs():
        cfg = get_config(arch)
        for s in cfg.shape_names():
            cells.append((arch, s))
    return cells
