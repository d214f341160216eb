"""Whether what the timed path served is correct.

After the window, a sample of the requests it answered, drawn from the
seed, is run through the plain float32 reference (``portbench.reference``),
which makes the served weights again from the seed: each row's prompt with
its served tokens, once. At each position that gave a served token the
reference's logits are read, and the number compared is the widest gap by
which a served token's logit lies below the reference's best
(``max_logit_gap``). Every request is one length, so any sample holds the
longest."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

SAMPLE_TOKENS = 384             # served tokens a run's check covers, at least
OUT_OF_RANGE = 1e9              # the gap of an answer of the wrong shape or an unknown id


WARM_UP = 2**32 - 1             # the warm-up invocations' prompt index


def _entropy(seed: int, *more: int) -> list:
    return [seed % 2**64, *more]


def prompt(seed: int, i: int, B: int, S: int, vocab: int) -> np.ndarray:
    """Request ``i``'s prompt: uniform ids below ``vocab``, from (seed, i)."""
    return np.random.default_rng(_entropy(seed, 0, i)).integers(0, vocab, (B, S),
                                                                dtype=np.int32)


def sample(answered: Sequence[int], B: int, K: int, seed: int) -> List[int]:
    """Indices of the requests the check covers: enough of the answered ones
    for ``SAMPLE_TOKENS`` served tokens (all of them if fewer), drawn from
    the seed."""
    n = min(len(answered), math.ceil(SAMPLE_TOKENS / (B * K)))
    pick = np.random.default_rng(_entropy(seed, 1)).choice(len(answered), size=n, replace=False)
    return sorted(answered[int(k)] for k in pick)


def gaps(cfg: dict, seed: int, device: str, items: List[Tuple[np.ndarray, np.ndarray]],
         precisions=("f32",)) -> Dict[str, float]:
    """``items``: (prompt [B, S], served tokens [B, K]) per sampled request.
    For precision ``f32`` the widest gap of a served token below the f32
    reference's best; for a lower one (the control), the widest gap of the
    token that precision puts first, each held against the f32 reference."""
    import torch
    from portbench.reference import weights
    from portbench.reference.arch import arch_of
    from portbench.reference.model import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    a = arch_of(cfg)
    w = weights.make(a, seed, device)
    models = {p: Reference(a, w, p) for p in ("f32",) + tuple(p for p in precisions
                                                             if p != "f32")}
    del w
    out = {p: 0.0 for p in precisions}
    with torch.no_grad():
        for prompt_ids, served in items:
            if served.shape != (prompt_ids.shape[0], cfg["function"]["decode_steps"]) or \
                    served.min() < 0 or served.max() >= a.vocab:
                return {p: OUT_OF_RANGE for p in precisions}
            S, K = prompt_ids.shape[1], served.shape[1]
            seq = np.concatenate([prompt_ids, served[:, :K - 1]], axis=1)
            tokens = torch.from_numpy(seq).to(device)
            at = list(range(S - 1, S + K - 1))
            ref = models["f32"].logits(tokens, at)                     # [B, K, V]
            best = ref.max(dim=-1).values
            for p in precisions:
                if p == "f32":
                    pick = torch.from_numpy(served.astype(np.int64)).to(device)
                else:
                    pick = models[p].logits(tokens, at).argmax(dim=-1)
                got = ref.gather(-1, pick[..., None])[..., 0]
                out[p] = max(out[p], float((best - got).max()))
    return out
