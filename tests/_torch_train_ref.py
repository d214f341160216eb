"""Shared set-up of the training tests of the port (``test_torch_loss.py``,
``test_torch_optim.py``, ``test_torch_train.py``): a reduced float32 config in
both packages, the JAX package's weights carried over to the port, seeded
batches, and the JAX reference compiled at XLA's lowest backend
optimisation level (the same computation; it compiles 2-3x faster, which
keeps these files inside the suite's time budget)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model

XLA_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                    "xla_llvm_disable_expensive_passes": True}


def configs(arch, **kw):
    """(JAX config, port config): ``arch`` reduced, in float32, with ``kw``."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def models(arch, max_seq):
    """(JAX model, JAX params, port model, port params on the CPU): the JAX
    package's ``init(PRNGKey(0))``, carried over by ``params_from_numpy``."""
    jcfg, tcfg = configs(arch)
    jm, tm = jax_build(jcfg, max_seq), build_model(tcfg, max_seq)
    jp = jit(jm.init, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def jit(fn, *args):
    """``fn(*args)`` through ``jax.jit``, compiled with ``XLA_FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=XLA_FAST_COMPILE)(*args)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's tests: the port's CPU training
    steps are many small ops, which run several times slower when the suite's
    workers each spread them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
