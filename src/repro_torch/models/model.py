"""Public model API (port of ``repro.models.model``): param specs, init,
the training loss, prefill and decode for one architecture and maximum
sequence length. A vision batch carries ``patches`` and an encoder-decoder
batch ``frames`` beside ``tokens`` (``repro_torch.models.frontends``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.dist.sharding import (
    active_rules, current_mesh, is_dtensor, local_shape_and_offset, pad_sharded, placements,
    replicated,
)
from repro_torch.dtypes import torch_dtype
from repro_torch.models.frontends import frontend_input_specs
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
        logz = torch.logsumexp(logits, dim=logits.dim() - 1)  # dims >= 0: DTensor, torch 2.11
        gold = _label_logits(logits, labels)
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
        """``inner`` zero-padded to the cache specs' shapes; under sharding
        rules, each leaf laid out by its spec's axes (``pad_sharded``)."""
        specs = stack_cache_specs(self.cfg, batch, capacity)
        rules, mesh = active_rules(), current_mesh()

        def pad(leaf, spec):
            if rules is not None and mesh is not None:
                return pad_sharded(leaf, spec.shape, placements(rules, mesh, spec.axes,
                                                                spec.shape), mesh)
            if tuple(leaf.shape) == tuple(spec.shape):
                return leaf
            out = leaf.new_zeros(spec.shape)
            out[tuple(slice(0, c) for c in leaf.shape)] = leaf
            return out

        return pytree.tree_map(pad, inner, specs)

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


def _label_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[b, s, labels[b, s]]`` -> [B, S]. On a DTensor each rank picks
    the labels that fall in its slice of the vocabulary, and where the vocab
    dim is sharded the ranks' picks are summed (``Partial``); DTensor's own
    rules for this gather (and its scatter-add backward) leave the mask the
    wrong shape on torch 2.13 and fail on torch 2.11."""
    labels = labels.long()
    if not is_dtensor(logits):
        return torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, pl = logits.device_mesh, logits.placements
    local = logits.to_local()
    _, offset = local_shape_and_offset(logits.shape, mesh, pl)
    row_pl = [Replicate() if p.is_shard(2) else p for p in pl]
    lab = replicated(labels, mesh).redistribute(mesh, row_pl).to_local() - offset[2]
    inside = (lab >= 0) & (lab < local.shape[2])
    picked = torch.take_along_dim(local, lab.clamp(0, local.shape[2] - 1)[..., None],
                                  dim=-1)[..., 0]
    picked = torch.where(inside, picked, 0.0)
    return DTensor.from_local(picked, mesh,
                              [Partial() if p.is_shard(2) else p for p in pl], run_check=False)


def build_model(cfg: ArchConfig, max_seq: int) -> Model:
    return Model(cfg, max_seq)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, batch_override: Optional[int] = None):
    """Meta-tensor inputs (shape and dtype, no storage) of the step that
    ``shape.kind`` selects, as the JAX package's ``input_specs``:

    train   -> {"tokens": int32 [B, S+1]} (+ the frontend's input)
    prefill -> {"tokens": int32 [B, S]}   (+ the frontend's input)
    decode  -> {"token":  int32 [B, 1]}   (the cache from ``Model.cache_specs``)

    int32, as the data pipeline gives tokens to ``Model.loss``."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def ids(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "train":
        d = {"tokens": ids(B, S + 1)}
        d.update(frontend_input_specs(cfg, B, S))
    elif shape.kind == "prefill":
        d = {"tokens": ids(B, S)}
        d.update(frontend_input_specs(cfg, B, S))
    elif shape.kind == "decode":
        d = {"token": ids(B, 1)}
    else:
        raise ValueError(shape.kind)
    return d
