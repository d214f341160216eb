"""The port's fault-tolerant trainer, its checkpoints and the training CLI.

* The four tests of ``tests/test_trainer.py`` on the port's ``Trainer`` (the
  reduced llama in float32 on the CPU): the loss decreases; a run stopped at
  step 6 and resumed in a fresh ``Trainer`` ends on the uninterrupted run's
  loss exactly; gradient accumulation stays close to the full batch; an
  injected slow step is logged as a straggler.
* Checkpoints across packages: the JAX ``Trainer`` checkpoints after 2 steps
  and the port's resumes from that directory and takes step 3, equal to the
  JAX trainer's own step 3 (loss within 1e-5 relative, params within 1e-5
  relative L2 per leaf); the other way round too.
* Each ``state_dtype``'s checkpoint (bf16 params, int8 ``{q, scale}``
  moments, the 0-d int32 step) restores in the other package byte for byte.
* A save that raises halfway leaves the latest complete checkpoint readable;
  an async save's error is raised by ``wait``; retention keeps ``keep``.
* ``python -m repro_torch.launch.train ... --device cpu`` runs 3 steps and
  resumes from its checkpoint directory.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_ref import one_torch_thread  # noqa: F401
from _torch_train_ref import configs
from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro_torch import pytree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.core import snapshot as tsnapshot
from repro_torch.launch import train as launch_train
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train import Trainer, TrainerConfig

STEP_RTOL = 1e-5


def _cfg():
    return configs("llama3.2-3b")[1]


def _tcfg(**kw):
    base = dict(seq_len=32, global_batch=4, steps=12, ckpt_every=6,
                log_every=100, ckpt_async=False)
    base.update(kw)
    return TrainerConfig(**base)


def _ocfg(steps=12):
    return AdamWConfig(peak_lr=1e-3, warmup=4, total_steps=steps)


def _trainer(tcfg, ocfg, ckpt_dir=None):
    return Trainer(_cfg(), tcfg, ocfg, ckpt_dir=ckpt_dir, device="cpu", log=lambda s: None)


# ----------------------------------------------------- tests/test_trainer.py

def test_loss_decreases(tmp_path):
    tr = _trainer(_tcfg(steps=25), _ocfg(25), str(tmp_path))
    tr.run()
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


def test_restart_resumes_exactly(tmp_path):
    """Train 12 straight vs train 6 + restart + 6: on the CPU the same final
    loss, bit for bit."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    t_full = _trainer(_tcfg(steps=12, ckpt_every=100), _ocfg(), str(d1))
    full = t_full.run()
    t_half = _trainer(_tcfg(steps=6, ckpt_every=6), _ocfg(), str(d2))
    t_half.run()
    t_resumed = _trainer(_tcfg(steps=12, ckpt_every=6), _ocfg(), str(d2))
    out = t_resumed.run()
    assert t_resumed.history[0]["step"] == 6          # resumed, not restarted
    assert t_resumed.history[-1]["loss"] == t_full.history[-1]["loss"]
    assert [h["loss"] for h in t_full.history[6:]] == [h["loss"] for h in t_resumed.history]
    for a, b in zip(pytree.leaves(out["params"]), pytree.leaves(full["params"])):
        assert torch.equal(a, b)


def test_grad_accum_close_to_full_batch():
    r1 = _trainer(_tcfg(steps=8, grad_accum=1), _ocfg(8)).run()
    r2 = _trainer(_tcfg(steps=8, grad_accum=2), _ocfg(8)).run()
    # same data, same model: losses should track closely (fp accumulation noise only)
    assert abs(r1["final_loss"] - r2["final_loss"]) < 0.05


def test_straggler_detection_fires_on_injected_delay():
    """A step 1 s and 10 x the slowest earlier step slower is a straggler
    (the delay scales with the step, which a loaded CPU slows)."""
    import time as _time
    tr = _trainer(_tcfg(steps=16, straggler_factor=2.5), _ocfg(16))
    orig = tr._step
    calls = {"n": 0, "slowest": 0.0}

    def slow_step(*a):
        calls["n"] += 1
        t0 = _time.perf_counter()
        out = orig(*a)
        if calls["n"] == 12:
            _time.sleep(max(1.0, 10 * calls["slowest"]))     # inject a straggler step
        elif calls["n"] > 1:
            calls["slowest"] = max(calls["slowest"], _time.perf_counter() - t0)
        return out

    tr._step = slow_step
    tr.run()
    assert any(e["step"] == 11 for e in tr.straggler_events), tr.straggler_events


def test_a_mesh_is_refused_not_ignored():
    with pytest.raises(NotImplementedError, match="A10b"):
        Trainer(_cfg(), _tcfg(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A10b"):
        Trainer(_cfg(), _tcfg(), rules=object(), device="cpu")


# ------------------------------------------------- checkpoints across packages

def _jax_tcfg(**kw):
    base = dict(seq_len=32, global_batch=4, steps=3, ckpt_every=2, log_every=100,
                ckpt_async=False)
    base.update(kw)
    return JaxTrainerConfig(**base)


def _jax_ocfg():
    return JaxAdamWConfig(peak_lr=1e-3, warmup=2, total_steps=3)


def _close_l2(got, want, what):
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= STEP_RTOL, (what, err)


def test_checkpoints_cross_between_packages_and_the_next_step_agrees(tmp_path):
    """JAX writes step 2, the port takes step 3 from it; the port writes step
    2, JAX takes step 3 from it. Each step 3 equals the writer's own."""
    jcfg = configs("llama3.2-3b")[0]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jt = JaxTrainer(jcfg, _jax_tcfg(), _jax_ocfg(), ckpt_dir=str(jdir), log=lambda s: None)
    jt.run(steps=2)
    shutil.copytree(jdir, tmp_path / "from_jax")
    jout = jt.run(steps=3)                              # JAX's own step 3
    assert jt.history[-1]["step"] == 2

    ocfg = AdamWConfig(peak_lr=1e-3, warmup=2, total_steps=3)
    tt = _trainer(_tcfg(steps=3, ckpt_every=2), ocfg, str(tmp_path / "from_jax"))
    tout = tt.run()
    assert [h["step"] for h in tt.history] == [2]       # resumed from JAX's step 2
    assert abs(tt.history[0]["loss"] - jt.history[-1]["loss"]) <= \
        STEP_RTOL * abs(jt.history[-1]["loss"])
    jflat = jax.tree_util.tree_flatten_with_path(jout["params"])[0]
    for (path, j), t in zip(jflat, pytree.leaves(tout["params"])):
        _close_l2(t, j, jax.tree_util.keystr(path))
    assert int(tout["opt_state"]["step"]) == 3

    # the other way round: the port writes step 2, JAX resumes from it
    tp = _trainer(_tcfg(steps=2, ckpt_every=2), ocfg, str(tdir))
    tp.run()
    shutil.copytree(tdir, tmp_path / "from_port")
    tp_out = _trainer(_tcfg(steps=3, ckpt_every=2), ocfg, str(tdir)).run()
    jt.ckpt = JaxCheckpointManager(tmp_path / "from_port", keep=3)
    jt.history.clear()
    jout2 = jt.run(steps=3)
    assert [h["step"] for h in jt.history] == [2]       # resumed from the port's step 2
    jflat = jax.tree_util.tree_flatten_with_path(jout2["params"])[0]
    for (path, j), t in zip(jflat, pytree.leaves(tp_out["params"])):
        _close_l2(t, j, jax.tree_util.keystr(path))


def _state_tree(state_dtype):
    """A bf16 param tree and the port's optimizer state after one update."""
    rng = np.random.default_rng(5)
    params = params_from_numpy({"w": rng.standard_normal((4, 6)).astype(np.float32),
                                "ln": {"scale": rng.standard_normal((2, 6)).astype(np.float32)},
                                "b": rng.standard_normal(6).astype(np.float32)}, device="cpu")
    params = pytree.tree_map(lambda t: t.to(torch.bfloat16), params)
    opt = AdamW(AdamWConfig(peak_lr=1e-2, warmup=1, state_dtype=state_dtype))
    grads = pytree.tree_map(lambda t: torch.randn(t.shape, generator=torch.Generator()
                                                  .manual_seed(t.numel())), params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    return {"params": params, "opt_state": state}


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_each_state_dtype_round_trips_and_crosses_byte_for_byte(tmp_path, state_dtype):
    tree = _state_tree(state_dtype)
    want = pytree.flatten_with_paths(tree)
    # the port writes; the port and JAX read
    CheckpointManager(tmp_path / "p").save(7, tree)
    back = CheckpointManager(tmp_path / "p").restore()
    jback = JaxCheckpointManager(tmp_path / "p").restore()
    jflat = [(jax.tree_util.keystr(p), x) for p, x in
             jax.tree_util.tree_flatten_with_path(jback)[0]]
    assert [p for p, _ in jflat] == [p for p, _ in want]
    for (path, w), (_, t), (_, j) in zip(want, pytree.flatten_with_paths(back), jflat):
        assert t.dtype == w.dtype and t.shape == w.shape, path
        assert _bytes(t) == _bytes(w) == _bytes(j), path
        assert str(w.dtype).removeprefix("torch.") == np.dtype(j.dtype).name, path
    assert back["opt_state"]["step"].dtype == torch.int32
    assert back["opt_state"]["step"].dim() == 0 and int(back["opt_state"]["step"]) == 1
    # JAX writes what it read; the port reads the same bytes
    JaxCheckpointManager(tmp_path / "j").save(7, jax.tree.map(jnp.asarray, jback))
    again = CheckpointManager(tmp_path / "j").restore(7)
    for (path, w), (_, t) in zip(want, pytree.flatten_with_paths(again)):
        assert t.dtype == w.dtype and _bytes(t) == _bytes(w), path


def test_a_save_that_raises_halfway_leaves_the_latest_checkpoint_readable(tmp_path,
                                                                            monkeypatch):
    tree = _state_tree("int8")
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(4, tree)
    calls = {"n": 0}
    real = tsnapshot.to_storable

    def failing(t):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("disk full")
        return real(t)

    monkeypatch.setattr(tsnapshot, "to_storable", failing)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(8, tree)
    assert mgr.steps() == [4] and mgr.latest_step() == 4
    fresh = CheckpointManager(tmp_path)
    restored, step = fresh.restore_latest_or_none()
    assert step == 4
    for a, b in zip(pytree.leaves(restored), pytree.leaves(tree)):
        assert torch.equal(a, b)
    # an async save's failure is raised by wait(), and the next save succeeds
    calls["n"] = 0
    mgr.save(8, tree, blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    monkeypatch.setattr(tsnapshot, "to_storable", real)
    mgr.save(8, tree, blocking=False)
    mgr.wait()
    assert mgr.steps() == [4, 8]


def test_retention_keeps_the_last_keep_checkpoints(tmp_path):
    tree = _state_tree("float32")
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, tree, blocking=step % 2 == 0)
    mgr.wait()
    assert mgr.steps() == [4, 5] and mgr.latest_step() == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0000000004",
                                                          "step_0000000005"]
    assert CheckpointManager(tmp_path / "empty").restore_latest_or_none() == (None, None)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


def test_save_is_a_point_in_time_copy(tmp_path):
    tree = {"w": torch.ones(3, 4)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree, blocking=False)
    tree["w"].add_(1.0)                       # the caller moves on at once
    mgr.wait()
    assert torch.equal(mgr.restore(1)["w"], torch.ones(3, 4))


# ------------------------------------------------------------------------ CLI

def test_the_cli_trains_three_steps_and_resumes(tmp_path, capsys):
    argv = ["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--dtype", "float32",
            "--seq-len", "16", "--batch", "2", "--warmup", "1", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path), "--opt-state-dtype", "int8"]
    first = launch_train.main(argv + ["--steps", "3"])
    assert [h["step"] for h in first["trainer"].history] == [0, 1, 2]
    assert CheckpointManager(tmp_path).steps() == [2, 3]
    second = launch_train.main(argv + ["--steps", "5"])
    assert [h["step"] for h in second["trainer"].history] == [3, 4]
    assert int(second["opt_state"]["step"]) == 5
    assert second["opt_state"]["m"]["embed"]["tok"]["q"].dtype == torch.int8
    assert next(iter(pytree.leaves(second["params"]))).device.type == "cpu"
    out = capsys.readouterr().out
    assert out.count("final loss:") == 2 and "resumed from step 3" in out
    assert dataclasses.is_dataclass(first["trainer"].tcfg)
