"""Public model API (port of ``repro.models.model``): param specs, init,
prefill and decode for one architecture and maximum sequence length."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import pytree
from repro_torch.configs.base import ArchConfig
from repro_torch.dtypes import torch_dtype
from repro_torch.models.layers import (
    ParamSpec, apply_norm, embed_tokens, embedding_specs, init_tree, is_spec, logits_head,
    norm_specs,
)
from repro_torch.models.transformer import (
    make_positions, uniform_cache_specs, uniform_decode, uniform_forward, uniform_specs,
)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    max_seq: int

    # ------------------------------------------------------------------ params
    def param_specs(self):
        dtype = torch_dtype(self.cfg.dtype)
        return {
            "embed": embedding_specs(self.cfg, dtype, self.max_seq),
            "stack": uniform_specs(self.cfg, dtype),
            "final": norm_specs(self.cfg, dtype),
        }

    def init(self, gen: torch.Generator):
        """Random weights on ``gen.device``, drawn from ``gen``."""
        return init_tree(self.param_specs(), gen)

    def _head(self, params, x):
        x = apply_norm(self.cfg, params["final"], x)
        return logits_head(self.cfg, params["embed"], x)

    # ----------------------------------------------------------------- prefill
    def prefill(self, params, batch: Dict, capacity: Optional[int] = None):
        """tokens [B, S] -> (last-position logits [B, V], cache) with the
        cache's K/V zero-padded to ``capacity`` positions."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        capacity = capacity or S
        positions = make_positions(self.cfg, B, S, device=tokens.device)
        x = embed_tokens(self.cfg, params["embed"], tokens)
        x, inner = uniform_forward(self.cfg, params["stack"], x, positions, "prefill")
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, {"inner": self._pad_cache(inner, B, capacity), "pos": S}

    def _pad_cache(self, inner, batch: int, capacity: int):
        target = pytree.tree_map(lambda s: s.shape,
                                 uniform_cache_specs(self.cfg, batch, capacity),
                                 is_leaf=is_spec)

        def pad(leaf, tshape):
            if tuple(leaf.shape) == tuple(tshape):
                return leaf
            out = leaf.new_zeros(tshape)
            out[tuple(slice(0, c) for c in leaf.shape)] = leaf
            return out

        return pytree.tree_map(pad, inner, target)

    # ------------------------------------------------------------------ decode
    def decode(self, params, cache, token: torch.Tensor):
        """token: [B, 1] int -> (logits [B, V], cache'). The K/V tensors of
        ``cache`` are written in place; ``pos`` advances by one."""
        pos = cache["pos"]
        if isinstance(pos, torch.Tensor) and pos.dim() == 0:
            pos = int(pos)
        x = embed_tokens(self.cfg, params["embed"], token, pos_offset=pos)
        x, inner = uniform_decode(self.cfg, params["stack"], x, cache["inner"], pos)
        logits = self._head(params, x)[:, 0]
        return logits, {"inner": inner, "pos": pos + 1}

    # ------------------------------------------------------------------- cache
    def cache_specs(self, batch: int, capacity: int):
        return {
            "inner": uniform_cache_specs(self.cfg, batch, capacity),
            "pos": ParamSpec((), torch.int32, (),
                             lambda gen, s, d: torch.zeros(s, dtype=d, device=gen.device)),
        }


def build_model(cfg: ArchConfig, max_seq: int) -> Model:
    return Model(cfg, max_seq)
