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
    make_positions, stack_cache_specs, stack_decode, stack_decode_paged, stack_forward,
    stack_page_pool_specs, stack_specs,
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
            "stack": stack_specs(self.cfg, dtype),
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
        cache's K/V zero-padded to ``capacity`` positions (a recurrent
        stack's state has no position axis)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        capacity = capacity or S
        positions = make_positions(self.cfg, B, S, device=tokens.device)
        x = embed_tokens(self.cfg, params["embed"], tokens)
        x, inner = stack_forward(self.cfg, params["stack"], x, positions, "prefill")
        logits = self._head(params, x[:, -1:])[:, 0]
        return logits, {"inner": self._pad_cache(inner, B, capacity), "pos": S}

    def _pad_cache(self, inner, batch: int, capacity: int):
        target = pytree.tree_map(lambda s: s.shape,
                                 stack_cache_specs(self.cfg, batch, capacity),
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
        """token: [B, 1] int -> (logits [B, V], cache'). The tensors of
        ``cache`` (K/V, or the recurrent state) are written in place; ``pos``
        advances by one."""
        pos = cache["pos"]
        if isinstance(pos, torch.Tensor) and pos.dim() == 0:
            pos = int(pos)
        x = embed_tokens(self.cfg, params["embed"], token, pos_offset=pos)
        x, inner = stack_decode(self.cfg, params["stack"], x, cache["inner"], pos)
        logits = self._head(params, x)[:, 0]
        return logits, {"inner": inner, "pos": pos + 1}

    # ------------------------------------------------------------- paged decode
    def decode_paged(self, params, k_pages, v_pages, page_table, pos, token: torch.Tensor):
        """One continuous-batching step against the shared page pool.

        k_pages/v_pages: [L, P, page_size, nkv, hd] (written in place);
        page_table: int32 [B, max_pages]; pos: int32 [B] (per-row current
        length; the host step loop owns it, mirroring the PagePool's chain
        state); token: [B, 1] int. Returns (logits [B, V], k_pages, v_pages).
        Rows whose table row is all zeros are empty slots: their reads and
        writes land on the null page and their logits are garbage the step
        loop discards. Uniform stack only.
        """
        x = embed_tokens(self.cfg, params["embed"], token, pos_offset=pos)
        x, k_pages, v_pages = stack_decode_paged(self.cfg, params["stack"], x, k_pages,
                                                 v_pages, page_table, pos)
        logits = self._head(params, x)[:, 0]
        return logits, k_pages, v_pages

    def page_pool_specs(self, n_pages: int, page_size: int):
        return stack_page_pool_specs(self.cfg, n_pages, page_size)

    def init_page_pool(self, n_pages: int, page_size: int, device):
        """Zero K and V pools on ``device``."""
        return init_tree(self.page_pool_specs(n_pages, page_size),
                         torch.Generator(device=torch.device(device)))

    # ------------------------------------------------------------------- cache
    def cache_specs(self, batch: int, capacity: int):
        return {
            "inner": stack_cache_specs(self.cfg, batch, capacity),
            "pos": ParamSpec((), torch.int32, (),
                             lambda gen, s, d: torch.zeros(s, dtype=d, device=gen.device)),
        }


def build_model(cfg: ArchConfig, max_seq: int) -> Model:
    return Model(cfg, max_seq)
