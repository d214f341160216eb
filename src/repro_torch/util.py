"""Probe-mode plumbing for cost extraction (port of ``repro.util``).

The dry run (``repro_torch.launch.dryrun``) traces small *probe* variants of
a cell (1-2 layers or periods, coarse attention blocks) and extrapolates
per-layer costs linearly (``repro_torch.launch.costmodel``), as the JAX
package does. In JAX the probes exist because XLA's cost analysis counts a
``lax.scan`` body once; the port's loops are Python loops, traced once per
trip, so a probe here costs what its layers cost and the extrapolation can
be held against the full trace.

``rscan`` is the counterpart of the JAX package's scan helper: a Python loop
over the leading dimension, in probe mode as outside it. ``probe_block``
coarsens a block size in probe mode only; outside probe mode every caller
computes exactly what it computed before.
"""
from __future__ import annotations

import contextlib
import threading


class _State(threading.local):
    def __init__(self):
        self.probe = False


_STATE = _State()


@contextlib.contextmanager
def probe_mode():
    prev = _STATE.probe
    _STATE.probe = True
    try:
        yield
    finally:
        _STATE.probe = prev


def in_probe_mode() -> bool:
    return _STATE.probe


# None, or ``runner(body, carry, x) -> (carry, y)`` that :func:`rscan`
# calls instead of ``body(carry, x)``: the dry run
# (``repro_torch.launch.dryrun``) replays the counts of a body it has traced
# with the same carry and slice layouts instead of tracing it again.
SCAN_RUNNER = None


def rscan(body, init, xs, length=None):
    """``lax.scan``'s contract as a Python loop: ``body(carry, x) -> (carry,
    y)`` over the leading dimension of every tensor of ``xs`` (a tensor, a
    tuple or dict of tensors, or None with ``length``) -> (carry, the ys
    stacked along a new leading dimension, or None where ``body`` gives
    None)."""
    import torch

    from repro_torch import pytree

    if xs is None:
        n = length
        slices = [None] * n
    else:
        leaves, struct = pytree.leaves(xs), pytree.structure(xs)
        n = leaves[0].shape[0] if length is None else length
        slices = [pytree.unflatten(struct, [t[i] for t in leaves]) for i in range(n)]
    step = body if SCAN_RUNNER is None else (lambda c, x: SCAN_RUNNER(body, c, x))
    carry, ys = init, []
    for x in slices:
        carry, y = step(carry, x)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    struct = pytree.structure(ys[0])
    stacked = [torch.stack(parts) for parts in zip(*(pytree.leaves(y) for y in ys))]
    return carry, pytree.unflatten(struct, stacked)


def probe_block(block: int, seq: int, target_iters: int = 4) -> int:
    """Coarsen a chunk size in probe mode so unrolled loops stay small."""
    if not _STATE.probe:
        return block
    return max(block, -(-seq // target_iters))
