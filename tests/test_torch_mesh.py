"""The port's Trainer on a mesh, its elastic re-mesh, the mesh launcher and
the serving CLI, against the JAX package.

On the CPU, in ``torch.distributed`` worlds of 2 and 4 processes (gloo over
a ``FileStore``, ``tests/_torch_world.py``), the reduced olmo-1b in float32:

* From one step-0 checkpoint of JAX's ``Trainer`` on a data=2 host mesh, the
  port's ``Trainer`` on a data=2 world takes the same 3 steps: each loss
  within 1e-5 relative (``STEP_RTOL`` of ``test_torch_train.py``), each
  parameter leaf within 1e-5 relative L2.
* A checkpoint JAX's ``Trainer`` wrote on its data=4 mesh resumes in the
  port on data=2, and the next step agrees within ``STEP_RTOL``.
* Elastic re-mesh: from the same JAX step-0 weights, the port checkpoints
  on data=2 and resumes on data=4 with ``first_step == 8`` and a final loss
  as ``test_elastic_remesh_resume`` bounds it (below the first run's + 0.1).
* AdamW's int8 moments on a (data=2, model=2) world, a weight sharded along
  its rows' axis, equal the single-device update bit for bit (the per-row
  amax is the global one).
* ``pick_backend``: gloo on the CPU, NCCL with a card per rank.
* ``python -m repro_torch.launch.serve --device cpu`` serves at a reduced
  size.
"""
import textwrap

import numpy as np
import pytest

from _torch_world import run_jax, run_world
from repro_torch.launch import mesh as tmesh

STEP_RTOL = 1e-5

_TCFG = ("seq_len=32, global_batch=8, log_every=100, ckpt_async=False")
_OCFG = "peak_lr=1e-3, total_steps=12"


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's Trainer: a step-0 checkpoint (copied for the port's runs) and 3
    steps on data=2, and 3 steps on data=4 with a checkpoint at step 2 ->
    (the directory, the losses)."""
    tmp_path = tmp_path_factory.mktemp("jax_runs")
    return tmp_path, run_jax(f"""
    import dataclasses, json, shutil
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.dist.sharding import make_rules
    from repro.optim import AdamWConfig
    from repro.train import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), dtype="float32")
    out = {{}}
    for n, steps, every, name in ((2, 3, 100, "d2"), (4, 3, 2, "d4")):
        mesh = jax.make_mesh((n,), ("data",), axis_types=(AxisType.Auto,),
                             devices=jax.devices()[:n])
        tr = Trainer(cfg, TrainerConfig({_TCFG}, steps=steps, ckpt_every=every),
                     AdamWConfig({_OCFG}, warmup=2), ckpt_dir="{tmp_path}/jax_" + name,
                     mesh=mesh,
                     rules=make_rules("train", mesh), log=lambda s: None)
        if name == "d2":
            params, opt_state = tr.init_state()
            tr.ckpt.save(0, {{"params": params, "opt_state": opt_state}}, blocking=True)
            shutil.copytree("{tmp_path}/jax_d2", "{tmp_path}/port_from0")
            shutil.copytree("{tmp_path}/jax_d2", "{tmp_path}/elastic")
        tr.run()
        out[name] = [h["loss"] for h in tr.history]
    shutil.copytree("{tmp_path}/jax_d4/step_0000000002", "{tmp_path}/port_from2/step_0000000002")
    print(json.dumps(out))
    """, 4)


_PORT_PRELUDE = f"""
import dataclasses
import numpy as np
from repro_torch import pytree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.dist.sharding import full_tree, make_rules
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig
ops.set_impl("plain")
cfg = dataclasses.replace(get_config("olmo-1b").reduced(), dtype="float32")

def trainer(n, steps, every, ckpt_dir, warmup=2):
    mesh = make_mesh((n,), ("data",), device="cpu")
    return Trainer(cfg, TrainerConfig({_TCFG}, steps=steps, ckpt_every=every),
                   AdamWConfig({_OCFG}, warmup=warmup), ckpt_dir=ckpt_dir, mesh=mesh,
                   rules=make_rules("train", mesh), log=lambda s: None, device="cpu")

def rel_l2(got, want):
    errs = []
    for g, w in zip(pytree.leaves(full_tree(got)), pytree.leaves(want)):
        g, w = g.double().numpy(), w.double().numpy()
        errs.append(float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)))
    return max(errs)
"""


def _port(body: str) -> str:
    return _PORT_PRELUDE + textwrap.dedent(body)


def test_the_trainer_on_data2_matches_jax_and_resumes_a_jax_data4_checkpoint(jax_runs):
    tmp_path, want = jax_runs
    got = run_world(tmp_path, 2, _port(f"""
    tr = trainer(2, 3, 100, "{tmp_path}/port_from0")
    out = tr.run()
    RESULT["from0"] = [h["loss"] for h in tr.history]
    RESULT["from0_params"] = rel_l2(out["params"],
                                    CheckpointManager("{tmp_path}/jax_d2").restore(3)["params"])
    tr = trainer(2, 3, 100, "{tmp_path}/port_from2")
    out = tr.run()
    RESULT["from2"] = [(h["step"], h["loss"]) for h in tr.history]
    RESULT["from2_params"] = rel_l2(out["params"],
                                    CheckpointManager("{tmp_path}/jax_d4").restore(3)["params"])
    """))
    for res in got:
        np.testing.assert_allclose(res["from0"], want["d2"], rtol=STEP_RTOL)
        assert res["from0_params"] <= STEP_RTOL, res
        assert [s for s, _ in res["from2"]] == [2]
        assert abs(res["from2"][0][1] - want["d4"][-1]) <= STEP_RTOL * abs(want["d4"][-1])
        assert res["from2_params"] <= STEP_RTOL, res


def test_elastic_remesh_from_data2_to_data4_and_int8_moments_on_a_mesh(jax_runs, tmp_path):
    """From JAX's step-0 weights, as test_elastic_remesh_resume starts."""
    ckpt = jax_runs[0] / "elastic"
    first = run_world(tmp_path, 2, _port(f"""
    tr = trainer(2, 8, 4, "{ckpt}", warmup=4)      # test_elastic_remesh_resume's run
    out = tr.run()
    RESULT.update(first_step=tr.history[0]["step"], final_loss=out["final_loss"])
    """))
    second = run_world(tmp_path, 4, _port(f"""
    tr = trainer(4, 12, 4, "{ckpt}", warmup=4)
    out = tr.run()
    RESULT.update(first_step=tr.history[0]["step"], final_loss=out["final_loss"])

    # int8 moments: a [4, 8] weight sharded on its rows' axis over model
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist.sharding import distribute_tree, use_rules
    from repro_torch.optim import AdamW
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    p = {{"w": torch.randn(4, 8, generator=gen)}}
    opt = AdamW(AdamWConfig(peak_lr=1e-2, warmup=1, total_steps=8, state_dtype="int8"))
    state = opt.init(p)
    sh = {{"w": (Replicate(), Shard(1))}}
    mom = {{"w": {{"q": (Replicate(), Shard(1)), "scale": (Replicate(), Replicate())}}}}
    osh = {{"m": mom, "v": mom, "step": (Replicate(), Replicate())}}
    dp, dstate = distribute_tree(p, sh, mesh), distribute_tree(state, osh, mesh)
    same = []
    for _ in range(3):
        g = {{"w": torch.randn(4, 8, generator=gen)}}
        p, state, _ = opt.update(g, state, p)
        with use_rules(make_rules("train", mesh), mesh):
            dp, dstate, _ = opt.update(distribute_tree(g, sh, mesh), dstate, dp)
        same.append(all(torch.equal(a, b) for a, b in zip(
            pytree.leaves(full_tree({{"p": dp, "s": dstate}})),
            pytree.leaves({{"p": p, "s": state}}))))
    RESULT["int8_equal"] = same
    """))
    assert first[0]["first_step"] == 0
    for res in second:
        assert res["first_step"] == 8                 # resumed, re-meshed, continued
        assert res["final_loss"] < first[0]["final_loss"] + 0.1
        assert res["int8_equal"] == [True, True, True]


def test_pick_backend_says_what_each_world_gets():
    assert tmesh.pick_backend("cpu", 4) == "gloo"
    n = tmesh.torch.cuda.device_count()
    if n == 0:
        assert tmesh.pick_backend("cuda", 4) == "gloo"     # ranks share (no) card
    assert tmesh.mesh_tag(type("M", (), {"mesh_dim_names": ("data", "model"),
                                         "mesh": np.zeros((2, 4))})()) == "data2xmodel4"


def test_the_serving_cli_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve
    gw = serve.main(["--device", "cpu", "--hosts", "1", "--batch", "2", "--prompt-len", "16",
                     "--decode-steps", "3", "--requests", "3", "--concurrency", "2"])
    out = capsys.readouterr().out
    assert "deploying llama3.2-3b@b2s16d3r" in out
    assert "e2e        n=    3" in out
    assert gw.dispatcher.retries == 0
