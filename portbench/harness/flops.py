"""Operations and bytes of the work a request asks for, counted from the
configuration's shapes: each input byte read once, each output byte written
once, whatever a kernel reads again.

A request is a prefill of ``B x S`` tokens and ``K - 1`` decode steps: the
prefill's logits give the first of its ``K`` tokens and each decode step the
next, so the logits of a ``K``-th step are not part of the answer."""
from __future__ import annotations

from portbench.reference.arch import Arch

BF16 = 2


def flash_cost(B: int, S: int, a: Arch, elt: int = BF16):
    """(FLOPs, bytes) of one causal prefill attention over ``S`` positions:
    two products of ``4 * B * Hq * D`` per (query, key) pair under the mask;
    q and the output, k and v each moved once."""
    pairs = S * (S + 1) // 2
    flops = 4.0 * B * a.n_heads * a.head_dim * pairs
    nbytes = (2 * B * S * a.n_heads + 2 * B * S * a.n_kv_heads) * a.head_dim * elt
    return flops, nbytes


def decode_cost(B: int, length: int, a: Arch, elt: int = BF16):
    """(FLOPs, bytes) of one decode attention of ``B`` rows over ``length``
    cached positions each: q and the output, the live K and V once, the
    lengths (int32)."""
    live = B * length
    flops = 4.0 * a.n_heads * a.head_dim * live
    nbytes = (2 * B * a.n_heads * a.head_dim + 2 * live * a.n_kv_heads * a.head_dim) * elt \
        + 4 * B
    return flops, nbytes


def decode_lengths(S: int, K: int):
    """The cache lengths of the ``K - 1`` decode steps of a request: the
    step at position ``S + j`` attends to ``S + j + 1`` positions."""
    return [S + j + 1 for j in range(K - 1)]


def _matmul_flops_per_token(a: Arch) -> float:
    q, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    per_layer = 2.0 * (a.d * q + 2 * a.d * kv + q * a.d) \
        + 2.0 * (3 if a.gated else 2) * a.d * a.ff
    return a.layers * per_layer


def request_flops(a: Arch, B: int, S: int, K: int) -> float:
    """Model FLOPs of one request: the projections and MLPs of every token,
    causal attention, and the logits of the ``K`` positions that give a
    token (the prefill's last and each decode step's)."""
    dense = _matmul_flops_per_token(a) * B * (S + K - 1)
    attn = a.layers * flash_cost(B, S, a)[0]
    attn += a.layers * sum(decode_cost(B, n, a)[0] for n in decode_lengths(S, K))
    head = 2.0 * B * K * a.d * a.vocab
    return dense + attn + head
