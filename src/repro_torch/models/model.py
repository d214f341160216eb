"""Public model API (port of ``repro.models.model``): param specs, init,
the training loss, prefill and decode for one architecture and maximum
sequence length. A vision batch carries ``patches`` and an encoder-decoder
batch ``frames`` beside ``tokens`` (``repro_torch.models.frontends``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.configs.base import ArchConfig
from repro_torch.dtypes import torch_dtype
from repro_torch.models.layers import (
    ParamSpec, apply_norm, embed_tokens, embedding_specs, init_tree, is_spec, logits_head,
    norm_specs,
)
from repro_torch.models.transformer import (
    encoder_forward, make_positions, stack_cache_specs, stack_decode, stack_decode_paged,
    stack_forward, stack_page_pool_specs, stack_specs,
)

LM_Z_LOSS = 1e-4


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

    # ------------------------------------------------------------------ shared
    def _embed(self, params, batch: Dict, tokens: torch.Tensor, pos_offset=0):
        """Token embeddings; a vision batch's ``patches`` [B, N, d] take the
        first N positions."""
        x = embed_tokens(self.cfg, params["embed"], tokens, pos_offset)
        if self.cfg.frontend == "vision" and "patches" in batch:
            npatch = batch["patches"].shape[1]
            x = torch.cat([batch["patches"].to(x.dtype), x[:, npatch:]], dim=1)
        return x

    def _n_patches(self, batch: Dict) -> int:
        if self.cfg.frontend == "vision" and "patches" in batch:
            return batch["patches"].shape[1]
        return 0

    def _enc_out(self, params, batch: Dict, train: bool = False):
        """The encoder's output over ``batch["frames"]`` (encoder-decoder
        only; a batch of tokens alone raises KeyError, as in the JAX
        package)."""
        if not self.cfg.enc_dec:
            return None
        return encoder_forward(self.cfg, params["stack"], batch["frames"], train=train)

    def _head(self, params, x):
        x = apply_norm(self.cfg, params["final"], x)
        return logits_head(self.cfg, params["embed"], x)

    # -------------------------------------------------------------------- loss
    def loss(self, params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Next-token cross-entropy over ``batch["tokens"]`` [B, S+1] (inputs
        ``[:, :-1]``, labels ``[:, 1:]``), plus the MoE aux loss and a
        ``LM_Z_LOSS`` z-loss on the log-normaliser, in float32 ->
        (total, {"loss", "ce", "aux", "zloss"}), as the JAX package's."""
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        B, S = inputs.shape
        positions = make_positions(self.cfg, B, S, self._n_patches(batch), device=tokens.device)
        enc_out = self._enc_out(params, batch, train=True)
        x = self._embed(params, batch, inputs)
        x, _, aux = stack_forward(self.cfg, params["stack"], x, positions, "train",
                                  enc_out=enc_out)
        logits = self._head(params, x).float()                          # [B, S, V]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
        ce = (logz - gold).mean()
        zloss = LM_Z_LOSS * logz.square().mean()
        total = ce + aux + zloss
        return total, {"loss": total, "ce": ce, "aux": aux, "zloss": zloss}

    # ----------------------------------------------------------------- prefill
    def prefill(self, params, batch: Dict, capacity: Optional[int] = None):
        """tokens [B, S] (and a frontend's ``frames`` or ``patches``) ->
        (last-position logits [B, V], cache) with the cache's K/V zero-padded
        to ``capacity`` positions (a recurrent stack's state has no position
        axis; the encoder's K/V keep ``encoder_seq``)."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        capacity = capacity or S
        positions = make_positions(self.cfg, B, S, self._n_patches(batch), device=tokens.device)
        enc_out = self._enc_out(params, batch)
        x = self._embed(params, batch, tokens)
        x, inner, _ = stack_forward(self.cfg, params["stack"], x, positions, "prefill",
                                    enc_out=enc_out)
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
        x = self._embed(params, {}, token, pos_offset=pos)
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
        x = self._embed(params, {}, token, pos_offset=pos)
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
