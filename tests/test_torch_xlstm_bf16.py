"""How far bf16 moves xLSTM's prefill logits from float32, in the JAX package
and in the port, on the same weights.

Random-weight xLSTM stacks amplify bf16 rounding with depth, so the
prefill-logit gate of ``chip_smoke.py`` says little at xlstm-1.3b's 48
blocks. This file settles whose amplification it is: the reduced-width
``xlstm-1.3b`` (d_model 128) with the published 7 mLSTM : 1 sLSTM ratio, the
JAX package's bf16 weights (``init(PRNGKey(0))``) carried over by
``convert.params_from_numpy``, prefill in bf16 and in float32 (the same
weights upcast) in each package; the relative L2 distance of the two
packages' bf16 logits from their own float32 logits must agree within 2x.
On the CPU the port runs its plain kernels.

    PYTHONPATH=src python tests/test_torch_xlstm_bf16.py 16 48

prints both distances at each depth.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch import pytree
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model

ARCH = "xlstm-1.3b"
SEQ, BATCH = 32, 2


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _at_depth(cfg, n_blocks):
    return dataclasses.replace(cfg, n_layers=n_blocks,
                               ssm=dataclasses.replace(cfg.ssm, slstm_every=8))


def logit_drift(n_blocks: int) -> dict:
    """rel-l2 of the bf16 prefill logits from the float32 ones, for the JAX
    package (``jax``) and the port (``port``), and of the port's float32
    logits from the JAX package's (``f32_port_vs_jax``)."""
    jcfg = _at_depth(jax_config(ARCH).reduced(), n_blocks)
    tcfg = _at_depth(get_config(ARCH).reduced(), n_blocks)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (BATCH, SEQ),
                                               dtype=np.int32)
    jm = jax_build(jcfg, SEQ)
    jp = jm.init(jax.random.PRNGKey(0))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)
    jm32 = jax_build(dataclasses.replace(jcfg, dtype="float32"), SEQ)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, capacity=SEQ)
    jl32, _ = jm32.prefill(jp32, {"tokens": jnp.asarray(tokens)}, capacity=SEQ)

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tp32 = pytree.tree_map(lambda t: t.float() if t.is_floating_point() else t, tp)
    tm = build_model(tcfg, SEQ)
    tm32 = build_model(dataclasses.replace(tcfg, dtype="float32"), SEQ)
    with torch.inference_mode():
        tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, capacity=SEQ)
        tl32, _ = tm32.prefill(tp32, {"tokens": torch.from_numpy(tokens)}, capacity=SEQ)
    jl32 = np.asarray(jl32, np.float32)
    return {"jax": _rel_l2(np.asarray(jl.astype(jnp.float32)), jl32),
            "port": _rel_l2(tl.float().numpy(), tl32.numpy()),
            "f32_port_vs_jax": _rel_l2(tl32.numpy(), jl32)}


def test_bf16_logit_drift_is_the_models_not_the_ports():
    """At 16 blocks (2 periods) the port's bf16 logits sit as far from its
    float32 logits as the JAX package's sit from its own, within 2x either
    way, on the same weights; the float32 paths agree."""
    d = logit_drift(16)
    assert d["f32_port_vs_jax"] < 1e-3
    assert 0.5 * d["jax"] <= d["port"] <= 2.0 * d["jax"], d


if __name__ == "__main__":
    for n in map(int, sys.argv[1:] or ["16", "48"]):
        print(f"{n} blocks: " + ", ".join(f"{k} {v:.6g}" for k, v in logit_drift(n).items()),
              flush=True)
