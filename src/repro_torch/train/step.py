"""Train-step builder (port of ``repro.train.step``): loss -> gradients
(optionally accumulated over micro-batches) -> AdamW update.

Gradients come from ``torch.autograd.grad`` over the parameter leaves, with
``requires_grad`` set on detached copies of them, so the custom ops' autograd
formulas (the VJP of their plain versions) run as under any other backward.
Gradient accumulation splits every batch leaf along axis 0 into
``[A, B/A, ...]``, sums the micro-batches' gradients in float32 and divides
by A, as the JAX package's ``lax.scan`` over micro-batches does; the metrics
are the micro-batches' mean. The batch is a dict of tensors on the
parameters' device.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch import pytree
from repro_torch.optim.adamw import AdamW

METRIC_KEYS = ("loss", "ce", "aux", "zloss")


def loss_and_grads(model, params, batch: Dict):
    """``model.loss`` on ``batch`` and its gradient -> (one gradient per leaf
    of ``params``, in JAX's flattening order, in the leaf's dtype; zeros for
    a leaf the loss does not reach, as ``jax.grad`` gives; the detached
    metrics)."""
    struct = pytree.structure(params)
    leaves = [p.detach().requires_grad_() for p in pytree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = model.loss(pytree.unflatten(struct, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return grads, {k: metrics[k].detach() for k in METRIC_KEYS}


def make_train_step(model, opt: AdamW, *, grad_accum: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def compute_grads(params, batch):
        if grad_accum <= 1:
            return loss_and_grads(model, params, batch)

        def split(x):
            if x.shape[0] % grad_accum:
                raise ValueError(f"a batch of {x.shape[0]} rows does not split into "
                                 f"{grad_accum} micro-batches")
            return x.reshape(grad_accum, x.shape[0] // grad_accum, *x.shape[1:])

        micro = {k: split(v) for k, v in batch.items()}
        device = pytree.leaves(params)[0].device
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
               for p in pytree.leaves(params)]
        metrics_acc = {k: torch.zeros((), dtype=torch.float32, device=device)
                       for k in METRIC_KEYS}
        for a in range(grad_accum):
            grads, metrics = loss_and_grads(model, params, {k: v[a] for k, v in micro.items()})
            acc = [s + g.float() for s, g in zip(acc, grads)]
            del grads
            metrics_acc = {k: metrics_acc[k] + metrics[k] / grad_accum for k in METRIC_KEYS}
        return [g / grad_accum for g in acc], metrics_acc

    def train_step(params, opt_state, batch: Dict):
        flat_grads, metrics = compute_grads(params, batch)
        grads = pytree.unflatten(pytree.structure(params), flat_grads)
        del flat_grads
        params, opt_state, stats = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step
