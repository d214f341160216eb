"""The port's dry run (``repro_torch.launch.dryrun``, ``costmodel``, ``util``,
``launch.mesh.make_production_mesh``) against the JAX package: the shape
suite, the cost arithmetic, the probe plans and the default pickers on
every (arch, shape) cell; per-device counts on fake worlds of 1, 4 and 8
ranks (no process is started); each custom op's FLOP formula by hand; and
that neither the cell orchestrator nor ``chip_smoke.py``'s reaper leaves a
process running."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tc
from repro_torch import pytree
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.dist.sharding import is_dtensor, make_rules
from repro_torch.kernels import ops
from repro_torch.launch import costmodel, dryrun
from repro_torch.launch.mesh import init_fake_world, make_mesh, make_production_mesh, mesh_tag
from repro_torch.models import input_specs
from repro_torch.util import in_probe_mode, probe_block, probe_mode, rscan

from repro import configs as jc


def _jax_modules():
    """The JAX package's dry run, cost model and util. Its dry run sets
    ``XLA_FLAGS`` (512 host devices) at import; the variable is put back, so
    later JAX tests in this process see the flags they started with."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro import util as jutil
        from repro.launch import costmodel as jcost
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdry, jcost, jutil


JDRY, JCOST, JUTIL = _jax_modules()
ROOT = Path(__file__).resolve().parents[1]
REMATS = ("full", "none")
CELLS = [(arch, shape) for arch in list_archs() for shape in get_config(arch).shape_names()]


@contextlib.contextmanager
def fake_world(n: int):
    import torch.distributed as dist
    init_fake_world(n)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the shape suite

@pytest.mark.parametrize("arch", list_archs())
def test_shape_suite_and_counts_equal_jax(arch):
    t, j = get_config(arch), jc.get_config(arch)
    assert t.shape_names() == j.shape_names()
    assert t.skipped_shapes() == j.skipped_shapes()
    assert t.param_counts() == j.param_counts()
    assert [t.layer_type(i) for i in range(t.n_layers)] == \
        [j.layer_type(i) for i in range(j.n_layers)]
    assert tc.SUBQUADRATIC_FAMILIES == jc.base.SUBQUADRATIC_FAMILIES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jc.SHAPES.items()}
    assert [f.name for f in dataclasses.fields(tc.ShapeSpec)] == \
        [f.name for f in dataclasses.fields(jc.ShapeSpec)]
    assert all(SHAPES[s].is_decode == jc.SHAPES[s].is_decode for s in SHAPES)
    assert tc.all_cells() == jc.all_cells()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_jax(arch, shape):
    from repro.models import input_specs as jax_input_specs
    t = input_specs(get_config(arch), SHAPES[shape])
    j = jax_input_specs(jc.get_config(arch), jc.SHAPES[shape])
    assert sorted(t) == sorted(j)
    for k in t:
        assert t[k].device.type == "meta"
        assert tuple(t[k].shape) == tuple(j[k].shape)
        assert str(t[k].dtype).replace("torch.", "") == np.dtype(j[k].dtype).name
    assert input_specs(get_config(arch), SHAPES[shape], batch_override=3)[
        "token" if shape.startswith(("decode", "long")) else "tokens"].shape[0] == 3


# --------------------------------------------------------- the cost arithmetic

def _plan(probes):
    return [(tag, c.n_layers, c.n_encoder_layers, ga, micro) for tag, c, ga, micro in probes]


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cost_arithmetic_and_plans_equal_jax(arch, shape, remat):
    t = dataclasses.replace(get_config(arch), remat=remat)
    j = dataclasses.replace(jc.get_config(arch), remat=remat)
    ts, js = SHAPES[shape], jc.SHAPES[shape]
    ga = dryrun.default_grad_accum(t, ts, 16)
    assert ga == JDRY.default_grad_accum(j, js, 16)
    assert dryrun.default_rules_preset(t, ts) == JDRY.default_rules_preset(j, js)
    assert dryrun.default_opt_dtype(t) == JDRY.default_opt_dtype(j)
    assert costmodel.analytic_flops(t, ts, grad_accum=ga) == \
        JCOST.analytic_flops(j, js, grad_accum=ga)
    assert costmodel.slstm_corrections(t, ts) == JCOST.slstm_corrections(j, js)
    tprobes, tcombine = costmodel.probe_variants(t, ts, ga)
    jprobes, jcombine = JCOST.probe_variants(j, js, ga)
    assert _plan(tprobes) == _plan(jprobes)
    for (_, tcfg, _, _), (_, jcfg, _, _) in zip(tprobes, jprobes):
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(sum(map(ord, arch + shape + remat)))
    measured = {tag: {k: float(rng.uniform(1.0, 1e12)) for k in costmodel.METRIC_KEYS}
                for tag, *_ in tprobes}
    got, want = tcombine(measured), jcombine(measured)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-9)
    assert costmodel.METRIC_KEYS == JCOST.METRIC_KEYS


def test_probe_block_and_probe_mode_equal_jax():
    grid = [(b, s, it) for b in (1, 16, 64, 512, 1024) for s in (1, 15, 64, 100, 4096, 32768)
            for it in (1, 2, 4, 7)]
    for mode_t, mode_j in ((contextlib.nullcontext(), contextlib.nullcontext()),
                           (probe_mode(), JUTIL.probe_mode())):
        with mode_t, mode_j:
            assert in_probe_mode() == JUTIL.in_probe_mode()
            assert [probe_block(*g) for g in grid] == [JUTIL.probe_block(*g) for g in grid]
    assert not in_probe_mode()


def test_rscan_matches_lax_scan():
    import jax
    import jax.numpy as jnp
    xs = np.arange(12, dtype=np.float32).reshape(4, 3)

    def body_j(c, x):
        return c * 0.5 + x, {"y": x * c, "z": x.sum()}

    def body_t(c, x):
        return c * 0.5 + x, {"y": x * c, "z": x.sum()}

    cj, yj = jax.lax.scan(body_j, jnp.ones(3), jnp.asarray(xs))
    ct, yt = rscan(body_t, torch.ones(3), torch.from_numpy(xs))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6)
    for k in ("y", "z"):
        np.testing.assert_allclose(yt[k].numpy(), np.asarray(yj[k]), rtol=1e-6)
    carry, ys = rscan(lambda c, _: (c + 1, None), 0, None, length=5)
    assert carry == 5 and ys is None


# --------------------------------------------------------- the custom ops' FLOPs

def _op_flops(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    costmodel.register_flop_formulas()
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def test_each_custom_op_formula_equals_a_hand_count():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    # flash: causal pairs 1 + 2 + 3 + 4 = 10; at q_offset 2 over 4 keys,
    # 3 + 4 = 7; bidirectional 3 x 5
    assert _op_flops(ops.attention, r(1, 4, 2, 8), r(1, 4, 1, 8), r(1, 4, 1, 8)) == \
        4 * 1 * 2 * 8 * 10
    assert _op_flops(lambda q, k, v: ops.attention(q, k, v, q_offset=2),
                     r(1, 2, 2, 8), r(1, 4, 1, 8), r(1, 4, 1, 8)) == 4 * 2 * 8 * 7
    assert _op_flops(lambda q, k, v: ops.attention(q, k, v, causal=False),
                     r(2, 3, 2, 8), r(2, 5, 2, 8), r(2, 5, 2, 8)) == 4 * 2 * 2 * 8 * 15
    # decode and its stats entry: the cache's 6 positions, whatever the length
    assert _op_flops(ops.decode_attention, r(2, 4, 8), r(2, 6, 2, 8), r(2, 6, 2, 8), 3) == \
        4 * 2 * 4 * 8 * 6
    assert _op_flops(ops.decode_attention_stats, r(2, 4, 8), r(2, 6, 2, 8),
                     r(2, 6, 2, 8), 3) == 4 * 2 * 4 * 8 * 6
    # paged: 3 pages of 4 per row
    table = torch.tensor([[1, 2, 0], [3, 0, 0]], dtype=torch.int32)
    assert _op_flops(ops.paged_decode_attention, r(2, 4, 8), r(4, 4, 2, 8), r(4, 4, 2, 8),
                     table, 5) == 4 * 2 * 4 * 8 * 12
    # mLSTM: per step and head 64 (Dk + Dv) + 4 Dk Dv
    assert _op_flops(ops.mlstm, r(1, 3, 2, 4), r(1, 3, 2, 4), r(1, 3, 2, 6), r(1, 3, 2),
                     r(1, 3, 2)) == 3 * 2 * (64 * 10 + 4 * 24)
    # the selective scan: 10 per step, channel and state
    assert _op_flops(ops.selective_scan, r(1, 5, 3), r(1, 5, 3).abs(), r(3, 2), r(1, 5, 2),
                     r(1, 5, 2), r(3)) == 10 * 5 * 3 * 2
    # sLSTM: the block-diagonal recurrence, 2 x H x dh x 4dh a step
    d, H = 6, 2
    dh = d // H
    z = torch.zeros(1, d)
    assert _op_flops(ops.slstm_scan, r(1, 5, 4 * d), r(H, dh, 4 * dh), r(4 * d), z, z, z,
                     z - 1e30) == 2 * 5 * H * dh * 4 * dh
    # the decode steps
    state = (torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 4), torch.zeros(2, 3))
    assert _op_flops(ops.mlstm_step, r(2, 3, 4), r(2, 3, 4), r(2, 3, 5), r(2, 3), r(2, 3),
                     state) == 4 * 2 * 3 * 4 * 5
    assert _op_flops(ops.mamba_step, r(2, 3), r(2, 3).abs(), r(3, 4), r(2, 4), r(2, 4), r(3),
                     torch.zeros(2, 3, 4)) == 10 * 2 * 3 * 4


# ------------------------------------------------------------------ fake worlds

def test_production_mesh_on_a_fake_world_of_512_ranks():
    with fake_world(512):
        assert mesh_tag(make_production_mesh(device="cpu")) == "data16xmodel16"
        mp = make_production_mesh(multi_pod=True, device="cpu")
        assert mesh_tag(mp) == "pod2xdata16xmodel16" and mp.mesh.numel() == 512
    with fake_world(64):
        with pytest.raises(ValueError, match="256 ranks"):
            make_production_mesh(device="cpu")


def test_per_device_flops_of_a_sharded_matmul_are_the_global_count_over_four():
    """``FlopCounterMode`` counts a DTensor matmul globally; the dry run's
    counter counts the local matmul that one rank runs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
        fake = dryrun.TraceFakeMode()
        with fake:
            a = DTensor.from_local(torch.empty(4, 16), mesh, [Shard(0), Replicate()],
                                   run_check=False)
            b = DTensor.from_local(torch.empty(16, 6), mesh, [Replicate(), Shard(1)],
                                   run_check=False)
            counter = dryrun.CostCounter(fake_mode=fake)
            with counter:
                a @ b
            with FlopCounterMode(display=False) as fc:
                a @ b
    assert fc.get_total_flops() == 2 * 8 * 16 * 12
    assert counter.flops == fc.get_total_flops() // 4
    assert counter.collectives["count"] == 0


def _shape(base: str, **kw):
    return dataclasses.replace(SHAPES[base], **kw)


def _local_bytes(tree) -> int:
    """Local bytes of the tensors of ``tree`` with a dim (the scalar step
    and position are left out, as on the JAX side)."""
    return sum((t.to_local() if is_dtensor(t) else t).numel() * t.element_size()
               for t in pytree.leaves(tree) if isinstance(t, torch.Tensor) and t.dim())


MINI = {  # JAX test_distributed.py's miniature cells
    "train": ("llama3.2-3b", "train_4k", dict(seq_len=64, global_batch=8), (2, 2, 2),
              ("pod", "data", "model"), "train", 2),
    "decode": ("qwen2.5-32b", "decode_32k", dict(seq_len=128, global_batch=4), (2, 4),
               ("data", "model"), "serve_tp", 1),
}

JAX_SHARD_BYTES = """
import dataclasses, json
import jax, numpy as np
from repro.configs import get_config, SHAPES
from repro.dist.sharding import make_rules, param_shardings
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.optim import AdamW, AdamWConfig
out = {}
for name, (arch, base, kw, mesh_shape, axes, preset, ga) in json.loads('CELLS').items():
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    shape = dataclasses.replace(SHAPES[base], **kw)
    mesh = make_mesh(tuple(mesh_shape), tuple(axes))
    rules = make_rules(preset, mesh)
    model = build_model(cfg, max_seq=shape.seq_len + 1)
    specs = model.param_specs()
    second = (AdamW(AdamWConfig(state_dtype="float32")).state_specs(specs)
              if shape.kind == "train" else model.cache_specs(shape.global_batch, shape.seq_len))
    row = []
    for tree in (specs, second):
        leaf = lambda s: hasattr(s, "axes")
        sh = jax.tree.leaves(param_shardings(tree, rules, mesh))
        sp = jax.tree.leaves(tree, is_leaf=leaf)
        row.append(sum(int(np.prod(n.shard_shape(tuple(s.shape)))) * np.dtype(s.dtype).itemsize
                       for s, n in zip(sp, sh) if s.shape != ()))
    out[name] = row
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_shard_bytes():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), TF_CPP_MIN_LOG_LEVEL="3", JAX_PLATFORMS="cpu")
    code = JAX_SHARD_BYTES.replace("CELLS", json.dumps(MINI))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(MINI))
def test_miniature_cells_on_a_fake_world_of_8_ranks(cell, jax_shard_bytes):
    """JAX's miniature dry runs (``tests/test_distributed.py``): the train cell
    reduces gradients across ranks; the decode cell traces with its cache
    sharded; in both, each rank's bytes of parameters and of optimizer state
    (or cache) are what JAX's ``NamedSharding.shard_shape`` gives the same
    ``param_shardings``."""
    arch, base, kw, mesh_shape, axes, preset, ga = MINI[cell]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    shape = _shape(base, **kw)
    with fake_world(8):
        mesh = make_mesh(mesh_shape, axes, device="cpu")
        rules = make_rules(preset, mesh)
        with dryrun.TraceFakeMode():
            _, args = dryrun.build_cell(cfg, shape, mesh, rules, grad_accum=ga,
                                        opt_dtype="float32", device="cpu")
            second = args[1]["inner"] if cell == "decode" else args[1]
            got = [_local_bytes(args[0]), _local_bytes(second)]
            if cell == "decode":
                leaves = [t for t in pytree.leaves(second) if isinstance(t, torch.Tensor)]
                assert any(tuple(t.to_local().shape) != tuple(t.shape) for t in leaves)
            del args, second
        rec = dryrun.trace_cell(cfg, shape, mesh, rules, grad_accum=ga, opt_dtype="float32",
                                device="cpu")
    assert got == jax_shard_bytes[cell]
    assert rec["flops_per_device"] > 0 and rec["memory"]["temp_size_in_bytes"] > 0
    if cell == "train":
        assert rec["collectives"]["count"] > 0 and rec["collectives"]["total"] > 0
        assert rec["collectives"]["all-reduce"] > 0        # grads reduce over pod and data
    else:
        assert rec["memory"]["alias_size_in_bytes"] > 0     # the cache, written in place


# ------------------------------------------- per-device counts against JAX's

# (arch, base shape, shape overrides, mesh, axes, preset, grad_accum, config
# overrides): MINI's train and decode cells, a cell whose model axis does
# not divide the head count (6 query heads over 4 model ranks), and one MoE
# cell under the default rules
CROSS = {
    "train": MINI["train"] + ({},),
    "decode": MINI["decode"] + ({},),
    "uneven_heads": ("llama3.2-3b", "train_4k", dict(seq_len=64, global_batch=8), (2, 4),
                     ("data", "model"), "train", 1, dict(n_heads=6, n_kv_heads=2,
                                                         d_model=192)),
    "moe": ("kimi-k2-1t-a32b", "train_4k", dict(seq_len=64, global_batch=8), (2, 4),
            ("data", "model"), "default", "default", {}),
}

# port / JAX per device. FLOPs: the port's counter counts the products (mm,
# bmm, the custom ops' formulas), XLA's cost analysis also every elementwise
# op and reduction (one a element) and its reference attention's whole
# causal square, so at these widths XLA counts up to ~20% more; a product
# that one side runs on whole weights where the other shards it shows as
# 1.5x and more (the backward's products on whole weights and the
# attention whole on every model rank read 1.55x in "moe", 1.60x in
# "uneven_heads").
# Collectives: both in the ring convention (result bytes, an all-reduce
# twice), but DTensor and XLA pick different collectives for one resharding
# (an all-gather where XLA all-reduces partial sums; XLA's all-to-all and
# collective-permute), so a factor 2 either way (the decode cell's cache
# of 2 kv heads, cut along head_dim over 4 model ranks, is resharded along
# its sequence by one all-to-all, where XLA all-reduces partial scores).
FLOPS_BAND = (0.8, 1.25)
COLL_BAND = (0.5, 2.0)

JAX_CROSS = """
import dataclasses, json
import jax
from repro.launch.dryrun import (build_cell, default_grad_accum, default_rules_preset,
                                 parse_collective_bytes)
from repro.configs import get_config, SHAPES
from repro.dist import compat
from repro.dist.sharding import make_rules
from repro.launch.mesh import make_mesh
from repro.util import probe_mode
out = {}
for name, (arch, base, kw, mesh_shape, axes, preset, ga, over) in json.loads('CELLS').items():
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **over)
    shape = dataclasses.replace(SHAPES[base], **kw)
    mesh = make_mesh(tuple(mesh_shape), tuple(axes))
    if preset == "default":
        preset = default_rules_preset(cfg, shape)
    if ga == "default":
        ga = default_grad_accum(cfg, shape, mesh.shape["data"])
    fn, args, in_sh, out_sh, donate = build_cell(cfg, shape, mesh, make_rules(preset, mesh),
                                                 grad_accum=ga, opt_dtype="float32")
    # every scan unrolled, as the JAX dry run's probes are: XLA's cost
    # analysis counts a loop body once
    with mesh, probe_mode():
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*args).compile()
    out[name] = {"flops": float(compat.cost_analysis(compiled).get("flops", 0.0)),
                 "collectives": parse_collective_bytes(compiled.as_text())["total"],
                 "preset": preset, "grad_accum": ga}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cross_counts():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TF_CPP_MIN_LOG_LEVEL="3",
               JAX_PLATFORMS="cpu")
    code = JAX_CROSS.replace("CELLS", json.dumps(CROSS))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CROSS))
def test_per_device_flops_and_collectives_against_jax_dry_run(cell, jax_cross_counts):
    """The port's ``trace_cell`` against the JAX package's dry run of the
    same miniature cell (``build_cell``, lowered and compiled for 8 host
    devices with every scan unrolled; ``cost_analysis`` FLOPs and
    ``parse_collective_bytes`` of the HLO): per-device FLOPs and collective
    bytes within the bands stated above (``pytest -s`` prints the table)."""
    arch, base, kw, mesh_shape, axes, _, _, over = CROSS[cell]
    want = jax_cross_counts[cell]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **over)
    shape = _shape(base, **kw)
    with fake_world(8):
        mesh = make_mesh(mesh_shape, axes, device="cpu")
        rules = make_rules(want["preset"], mesh)
        rec = dryrun.trace_cell(cfg, shape, mesh, rules, grad_accum=want["grad_accum"],
                                opt_dtype="float32", device="cpu")
    flops = rec["flops_per_device"] / want["flops"]
    coll = rec["collectives"]["total"] / want["collectives"]
    print(f"\n{cell} ({arch}, {want['preset']}, mesh {mesh_shape}): FLOPs port "
          f"{rec['flops_per_device']:.4g} JAX {want['flops']:.4g} ratio {flops:.3f} | "
          f"collective bytes port {rec['collectives']['total']} JAX "
          f"{want['collectives']:.0f} ratio {coll:.3f}")
    assert FLOPS_BAND[0] <= flops <= FLOPS_BAND[1], (cell, flops)
    assert COLL_BAND[0] <= coll <= COLL_BAND[1], (cell, coll)


def test_one_rank_fake_trace_equals_a_real_cpu_step():
    """On a 1-rank world the fake trace of a reduced train cell counts the
    FLOPs ``FlopCounterMode`` counts over a real CPU step (plain path, remat
    ``full``, 3 micro-batches: the third replayed from the second, and each
    flash VJP after the first replayed), and its arguments and peak are what
    the counter sees on the real step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), remat="full",
                              dtype="float32")
    shape = _shape("train_4k", name="train_64", seq_len=64, global_batch=12)
    with fake_world(1):
        rec = dryrun.trace_cell(cfg, shape, None, None, grad_accum=3, opt_dtype="float32",
                                device="cpu")
    tr = Trainer(cfg, TrainerConfig(seq_len=64, global_batch=12, grad_accum=3, steps=1),
                 AdamWConfig(), device="cpu", log=lambda s: None)
    params, opt_state = tr.init_state()
    batch = tr._batch(0)
    with FlopCounterMode(display=False) as fc:
        tr._step(params, opt_state, batch)
    params, opt_state = tr.init_state()
    counter = dryrun.CostCounter()
    arg_bytes = counter.add_arguments(pytree.leaves(params) + pytree.leaves(opt_state)
                                      + list(batch.values()))
    with counter:
        tr._step(params, opt_state, batch)
    assert rec["flops_per_device"] == fc.get_total_flops() == counter.flops > 0
    assert rec["vjp_replays"] > 0 and rec["scan_replays"] == 1
    assert rec["collectives"]["total"] == counter.collectives_record()["total"] == 0
    assert rec["memory"]["argument_size_in_bytes"] == arg_bytes
    assert rec["memory"]["temp_size_in_bytes"] == counter.peak


# ------------------------------------------------------------- process hygiene

def _alive(pid: int) -> bool:
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except OSError:
        return False
    return state != "Z"


def test_all_cells_cli_kills_each_cells_session_on_timeout(tmp_path, monkeypatch, capsys):
    """A cell that starts a grandchild and sleeps past the timeout: the cell
    and its grandchild are both gone when the call returns, and the failure
    is reported."""
    pids = tmp_path / "pids"
    sleeper = textwrap.dedent(f"""
        import os, subprocess, sys, time
        g = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(300)"])
        with open({str(pids)!r}, "a") as f:
            f.write(f"{{os.getpid()}} {{g.pid}}\\n")
        time.sleep(300)
    """)
    monkeypatch.setattr(dryrun, "list_archs", lambda: ["llama3.2-3b"])
    t0 = time.monotonic()
    rc = dryrun.all_cells_cli(jobs=3, out_dir=str(tmp_path / "out"), multi_pod_also=False,
                              timeout=2, command=lambda *a: [sys.executable, "-c", sleeper],
                              poll_s=0.2)
    assert rc == 1 and time.monotonic() - t0 < 60
    out = capsys.readouterr().out
    assert out.count("FAIL rc=-9") == 3 and "3 failures" in out
    started = [int(p) for line in pids.read_text().splitlines() for p in line.split()]
    assert len(started) == 6
    assert not [p for p in started if _alive(p)]


REAPER = """
import importlib.util, json, os, subprocess, sys, time
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.become_subreaper()
# a child that starts a grandchild and exits: the grandchild is adopted
child = subprocess.Popen([sys.executable, "-c",
    "import subprocess, sys; g = subprocess.Popen([sys.executable, '-c', "
    "'import time; time.sleep(300)']); print(g.pid, flush=True)"], stdout=subprocess.PIPE)
grandchild = int(child.stdout.readline())
child.wait()
before = cs.processes_left()
cs.reap_children()
after = cs.processes_left()
# a leftover planted past the reaper: the end-of-run check names it
cs.reap_children = lambda *a, **k: None
planted = []
def run():
    planted.append(subprocess.Popen([sys.executable, "-c", "import time; time.sleep(300)"]))
    return {"ok": True}
try:
    cs.leave_nothing_running(run)
    raised = ""
except RuntimeError as e:
    raised = str(e)
planted[0].kill(); planted[0].wait()
print(json.dumps({"grandchild": grandchild, "before": sorted(before), "after": sorted(after),
                  "planted": planted[0].pid, "raised": raised}))
"""


def test_chip_smoke_reaper_leaves_nothing_and_names_a_leftover():
    out = subprocess.run([sys.executable, "-c", REAPER, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["grandchild"] in r["before"] and r["after"] == []
    assert not _alive(r["grandchild"])
    assert f"pid {r['planted']}" in r["raised"] and "time.sleep(300)" in r["raised"]


@pytest.mark.parametrize("arch,base", [("starcoder2-3b", "train_4k"),
                                       ("xlstm-1.3b", "prefill_32k")])
def test_heads_that_16_ranks_do_not_divide_trace(arch, base):
    """24 query heads over 16 model ranks (starcoder2's, 2 kv heads), and 4
    mLSTM heads: the head splits gather the flat dim first, and the
    gradient of the merged heads comes back laid out as they were (DTensor
    refuses an uneven head split either way)."""
    full = get_config(arch)
    layers = full.ssm.slstm_every if full.ssm else 2
    cfg = dataclasses.replace(full, n_layers=layers, d_model=full.n_heads * 8, head_dim=8,
                              d_ff=64 if full.d_ff else 0, vocab_size=256, dtype="float32")
    shape = _shape(base, seq_len=32, global_batch=16)
    with fake_world(16):
        mesh = make_mesh((1, 16), ("data", "model"), device="cpu")
        rules = make_rules(dryrun.default_rules_preset(full, SHAPES[base]), mesh)
        rec = dryrun.trace_cell(cfg, shape, mesh, rules, grad_accum=1, opt_dtype="float32",
                                device="cpu")
    assert rec["flops_per_device"] > 0 and rec["collectives"]["all-gather"] > 0
