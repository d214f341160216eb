"""Modality frontend stubs (port of ``repro.models.frontends``): the backbone
takes precomputed embeddings.

* audio (whisper): ``[B, encoder_seq, d_model]`` frame embeddings, what the
  2x-strided conv stem would make of 30 s of log-mel spectrogram;
* vision (qwen2-vl): ``[B, n_patches, d_model]`` patch embeddings, what the
  ViT patch merger would make of one image at base resolution, merged at the
  prompt's prefix positions with M-RoPE (t, h, w) ids over the patch grid.

Neither is a ``FunctionSpec`` input: the serve program takes tokens only, as
in the JAX package, so these families are entered through ``Model.prefill``
and ``Model.decode`` with the batch fields below.
"""
from __future__ import annotations

import math

import torch

from repro_torch.dtypes import torch_dtype

N_PATCHES = 256  # 16x16 patch grid stub for the VLM (full-size shapes)


def n_patches_for(seq_len: int) -> int:
    """Largest square patch grid that fits in half the sequence (caps at 16x16)."""
    g = min(16, max(int(math.isqrt(max(seq_len // 2, 1))), 1))
    return g * g


def _shapes(cfg, batch: int, seq_len: int) -> dict:
    if cfg.frontend == "audio":
        return {"frames": (batch, cfg.encoder_seq, cfg.d_model)}
    if cfg.frontend == "vision":
        return {"patches": (batch, n_patches_for(seq_len), cfg.d_model)}
    return {}


def frontend_input_specs(cfg, batch: int, seq_len: int) -> dict:
    """The extra inputs the frontend stub injects, keyed by batch field name,
    as meta tensors (shape and dtype, no storage)."""
    dt = torch_dtype(cfg.dtype)
    return {name: torch.empty(shape, dtype=dt, device="meta")
            for name, shape in _shapes(cfg, batch, seq_len).items()}


def synth_frontend(cfg, batch: int, seq_len: int, gen: torch.Generator) -> dict:
    """Random stand-ins for the precomputed embeddings, standard normal in the
    model dtype, drawn from ``gen`` on its device."""
    dt = torch_dtype(cfg.dtype)
    return {name: torch.randn(shape, generator=gen, device=gen.device).to(dt)
            for name, shape in _shapes(cfg, batch, seq_len).items()}
