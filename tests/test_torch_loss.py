"""The port's training loss, its gradients and layer remat vs the JAX package.

Each architecture at the JAX package's ``reduced()`` cut in float32, with the
JAX package's weights from ``build_model(cfg).init(PRNGKey(0))`` carried over
by ``params_from_numpy`` (``_torch_train_ref``) and seeded numpy tokens ([2, 17]: 16 inputs and
their shifted labels; whisper with seeded frames, qwen2-vl also with seeded
patches). The JAX side runs its reference path on the CPU, the port its plain
kernels.

* ``Model.loss``: total, ce, aux and zloss within 1e-5 relative of JAX's,
  for all ten architectures.
* Gradients: ``jax.grad`` of the loss against the port's autograd, each leaf
  within a relative L2 error of 1e-4 (llama, arctic with its MoE aux loss,
  xlstm, jamba, whisper). A leaf's error is taken relative to its own norm,
  floored at ``GRAD_FLOOR`` of the whole gradient's norm: the attention key
  biases' gradient is zero up to rounding (a shift shared by every key leaves
  the softmax unchanged), about 1e-9 of the whole in both packages.
* Remat: ``"none"``, ``"full"`` and ``"dots"`` give the same loss and
  gradients in the port (within 1e-6), ``"full"`` and ``"dots"`` keep fewer
  tensors for the backward than ``"none"``, and the serve program's export
  is the same under every remat.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import one_torch_thread  # noqa: F401
from _torch_train_ref import configs as _configs
from _torch_train_ref import jit, models
from repro.configs import list_archs as jax_archs
from repro_torch import pytree
from repro_torch.configs import list_archs
from repro_torch.core.artifact import FunctionSpec
from repro_torch.core.deploy import make_serve_fn
from repro_torch.models import build_model
from repro_torch.models import frontends as tfront
from repro_torch.models.model import LM_Z_LOSS

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-4
REMAT_TOL = 1e-6
B, S = 2, 16
ARCHS = sorted(jax_archs())
GRAD_ARCHS = ["llama3.2-3b", "arctic-480b", "xlstm-1.3b", "jamba-1.5-large-398b",
              "whisper-medium"]


def _models(arch):
    return models(arch, S + 1)


def _batch(cfg, patches: bool = False, seed: int = 1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                              ).astype(np.float32)
    if patches:
        n = tfront.n_patches_for(S)
        batch["patches"] = rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_loss(arch, patches: bool, grads: bool):
    """JAX's (total, metrics[, grads]) as numpy, one jit per architecture."""
    jm, jp, _, _ = _models(arch)
    batch = {k: jnp.asarray(v) for k, v in _batch(jm.cfg, patches).items()}
    if grads:
        (total, metrics), g = jit(jax.value_and_grad(jm.loss, has_aux=True), jp, batch)
        return total, metrics, g
    total, metrics = jit(jm.loss, jp, batch)
    return total, metrics, None


def _port_loss(tm, tp, batch, grads: bool = False):
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if not grads:
        with torch.no_grad():
            return tm.loss(tp, tbatch), None
    struct = pytree.structure(tp)
    leaves = [p.detach().clone().requires_grad_() for p in pytree.leaves(tp)]
    total, metrics = tm.loss(pytree.unflatten(struct, leaves), tbatch)
    g = torch.autograd.grad(total, leaves, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)]
    return (total, metrics), g


def _rel(got, want) -> float:
    want = float(want)
    return abs(float(torch.as_tensor(got).detach()) - want) / max(abs(want), 1e-30)


CASES = [(a, False) for a in ARCHS] + [("qwen2-vl-2b", True)]


def test_the_port_registers_every_architecture_of_the_jax_package():
    assert len(ARCHS) == 10 and set(ARCHS) <= set(list_archs())
    from repro.models import model as jmodel
    assert LM_Z_LOSS == jmodel.LM_Z_LOSS


@pytest.mark.parametrize("arch,patches", CASES,
                         ids=[a + ("-patches" if p else "") for a, p in CASES])
def test_loss_and_its_parts_match_jax(arch, patches):
    jm, _, tm, tp = _models(arch)
    batch = _batch(tm.cfg, patches)
    _, jmet, _ = _jax_loss(arch, patches, arch in GRAD_ARCHS and not patches)
    (total, tmet), _ = _port_loss(tm, tp, batch)
    assert sorted(tmet) == sorted(jmet) == ["aux", "ce", "loss", "zloss"]
    for key in jmet:
        assert tmet[key].dtype == torch.float32 and tmet[key].dim() == 0, key
        if float(jmet[key]) == 0.0:
            assert float(tmet[key]) == 0.0, key            # no MoE: aux is 0
        else:
            assert _rel(tmet[key], jmet[key]) <= LOSS_RTOL, (key, float(tmet[key]),
                                                             float(jmet[key]))
    assert total is tmet["loss"]
    has_moe = jm.cfg.moe is not None
    assert (float(tmet["aux"]) > 0) == has_moe


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax_grad_leaf_by_leaf(arch):
    jm, jp, tm, tp = _models(arch)
    total_j, _, jg = _jax_loss(arch, False, True)
    (total, _), tg = _port_loss(tm, tp, _batch(tm.cfg), grads=True)
    assert _rel(total, total_j) <= LOSS_RTOL
    jflat = [(jax.tree_util.keystr(p), np.asarray(x, np.float64))
             for p, x in jax.tree_util.tree_flatten_with_path(jg)[0]]
    tpaths = [p for p, _ in pytree.flatten_with_paths(tp)]
    assert [p for p, _ in jflat] == tpaths
    floor = GRAD_FLOOR * np.sqrt(sum(np.sum(w * w) for _, w in jflat))
    worst, small = [], []
    for (path, want), got in zip(jflat, tg):
        assert tuple(got.shape) == want.shape, path
        norm = np.linalg.norm(want)
        worst.append((np.linalg.norm(got.double().numpy() - want) / max(norm, floor), path))
        if norm < floor:
            small.append(path)
    worst.sort(reverse=True)
    assert worst[0][0] <= GRAD_RTOL, worst[:3]
    assert all(p.endswith("['bk']") for p in small), small


REMAT_ARCHS = ["llama3.2-3b", "arctic-480b", "xlstm-1.3b", "jamba-1.5-large-398b",
               "whisper-medium"]


def _remat_run(arch, remat):
    _, tcfg = _configs(arch, remat=remat)
    _, _, _, tp = _models(arch)
    tm = build_model(tcfg, S + 1)
    saved = [0]

    def pack(t):
        saved[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        (total, metrics), g = _port_loss(tm, tp, _batch(tcfg), grads=True)
    return total, g, saved[0]


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    base_total, base_g, base_saved = _remat_run(arch, "none")
    for remat in ("full", "dots"):
        total, g, saved = _remat_run(arch, remat)
        assert abs(float(total) - float(base_total)) <= REMAT_TOL * abs(float(base_total))
        for a, b in zip(g, base_g):
            scale = max(float(b.abs().max()), 1e-30)
            assert float((a - b).abs().max()) <= REMAT_TOL * scale, remat
        # the outer graph keeps fewer tensors for the backward than without remat
        assert saved < base_saved, (remat, saved, base_saved)


def test_remat_is_refused_for_an_unknown_policy():
    _, tcfg = _configs("llama3.2-3b", remat="everything")
    _, _, _, tp = _models("llama3.2-3b")
    with pytest.raises(ValueError, match="remat"):
        _port_loss(build_model(tcfg, S + 1), tp, _batch(tcfg), grads=True)


def _serve_graph(remat):
    _, tcfg = _configs("llama3.2-3b", remat=remat)
    model = build_model(tcfg, S + 2)
    _, _, _, tp = _models("llama3.2-3b")
    spec = FunctionSpec(arch="llama3.2-3b", batch_size=B, prompt_len=S, decode_steps=2)
    tokens = torch.from_numpy(_batch(tcfg)["tokens"][:, :S])
    exported = torch.export.export(make_serve_fn(model, spec), (tp, tokens))
    return [str(n.target) for n in exported.graph.nodes]


def test_the_serve_program_export_is_the_same_under_every_remat():
    """Remat applies to the train-mode layer bodies only: a prefill and its
    decode steps export the same graph, with no checkpoint op, whatever the
    config's remat."""
    base = _serve_graph("none")
    for remat in ("full", "dots"):
        nodes = _serve_graph(remat)
        assert len(nodes) == len(base) and nodes == base, remat
        assert not [n for n in nodes if "checkpoint" in n or "tag_activation" in n]
