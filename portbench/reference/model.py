"""The forward pass of a dense pre-norm decoder in plain PyTorch, float32.

Per the published models (OLMo, StarCoder2): token embedding; per layer
``x + attn(norm(x))`` then ``x + mlp(norm(x))``; a final norm; logits against
the tied embedding. Attention is causal with grouped K/V heads, rotary
position embedding on the split halves of each head (``rotate_half``) with
the configuration's ``rope_theta``, and scores scaled by ``1/sqrt(D)``. The
MLP is SwiGLU (``down(silu(gate x) * up x)``) or tanh-GELU with biases.
OLMo's LayerNorm has no scale or bias.

``precision="fp8"`` is the control of the benchmark's check: every operand
of a projection, an MLP product and the logits is rounded to float8 e4m3
(activations with a scale per token, weights per output column, each at its
amax over 448) before a float32 product: the step below the bfloat16 the
configurations are served in.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.arch import Arch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """``weights``: the served parameters by path (``weights.make``), kept
    here in float32."""

    def __init__(self, a: Arch, weights: Dict[str, torch.Tensor], precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.a, self.precision = a, precision
        self.w = {k: v.float() for k, v in weights.items()}
        if precision == "fp8":
            for k, v in self.w.items():
                if k.startswith("layers.") and ".w" in k or k == "embed.unembed":
                    self.w[k] = _fp8(v, dim=-2)            # per output column
            self.head = _fp8(self.w["embed.tok"], dim=1)   # per vocabulary row
        else:
            self.head = self.w["embed.tok"]
        if not a.tied:
            self.head = self.w["embed.unembed"].T

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = _fp8(x, dim=-1)
        return x @ w

    def _norm(self, x: torch.Tensor, prefix: str, layer=None) -> torch.Tensor:
        if not self.a.norm_affine:
            return F.layer_norm(x, (x.shape[-1],), eps=self.a.norm_eps)
        pick = (lambda t: t) if layer is None else (lambda t: t[layer])
        return F.layer_norm(x, (x.shape[-1],), pick(self.w[f"{prefix}.scale"]),
                            pick(self.w[f"{prefix}.bias"]), self.a.norm_eps)

    def _rope(self, T: int, device):
        hd = self.a.head_dim
        inv = 1.0 / (self.a.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                        device=device) / hd))
        ang = torch.arange(T, dtype=torch.float32, device=device)[:, None] * inv.float()
        return torch.cos(ang), torch.sin(ang)                      # [T, hd/2]

    @staticmethod
    def _rotate(x: torch.Tensor, cos, sin) -> torch.Tensor:        # x [B, T, H, hd]
        h = x.shape[-1] // 2
        x1, x2 = x[..., :h], x[..., h:]
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)

    def logits(self, tokens: torch.Tensor, at: Sequence[int]) -> torch.Tensor:
        """tokens [B, T] (int) -> float32 logits [B, len(at), V] at the
        positions ``at``."""
        a, w = self.a, self.w
        B, T = tokens.shape
        x = w["embed.tok"][tokens.long()]
        cos, sin = self._rope(T, x.device)
        mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        G = a.n_heads // a.n_kv_heads
        for i in range(a.layers):
            def lw(name):
                return w[f"layers.{name}"][i]
            h = self._norm(x, "layers.ln1", i)
            q = self._mm(h, lw("attn.wq"))
            k = self._mm(h, lw("attn.wk"))
            v = self._mm(h, lw("attn.wv"))
            if a.bias:
                q, k, v = q + lw("attn.bq"), k + lw("attn.bk"), v + lw("attn.bv")
            q = self._rotate(q.view(B, T, a.n_heads, a.head_dim), cos, sin)
            k = self._rotate(k.view(B, T, a.n_kv_heads, a.head_dim), cos, sin)
            v = v.view(B, T, a.n_kv_heads, a.head_dim)
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(a.head_dim)
            s = s.masked_fill(~mask, float("-inf")).softmax(dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", s, v).reshape(B, T, a.n_heads * a.head_dim)
            o = self._mm(o, lw("attn.wo"))
            x = x + (o + lw("attn.bo") if a.bias else o)
            h = self._norm(x, "layers.ln2", i)
            if a.gated:
                u = F.silu(self._mm(h, lw("mlp.w_gate"))) * self._mm(h, lw("mlp.w_up"))
            else:
                u = self._mm(h, lw("mlp.w_up"))
                u = F.gelu(u + lw("mlp.b_up") if a.bias else u, approximate="tanh")
            y = self._mm(u, lw("mlp.w_down"))
            x = x + (y + lw("mlp.b_down") if a.bias else y)
        h = self._norm(x[:, list(at)], "final")
        return self._mm(h, self.head.T)
