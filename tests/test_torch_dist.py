"""The port's multi-device layer (``repro_torch.dist``) against ``repro.dist``.

On the CPU, in ``torch.distributed`` worlds of 4 processes (gloo over a
``FileStore``, ``tests/_torch_world.py``), all in float32:

* Rules: ``Rules.spec`` equals the JAX package's for every preset over a
  grid of shapes and mesh sizes (no devices), and the property tests of
  ``tests/test_sharding.py`` hold for the port's ``Rules``.
* Placements: for every preset on ``(data=2, model=2)`` and on
  ``(pod=2, data=2)``, each rank's local slice of a tensor equals the slice
  JAX's ``NamedSharding.devices_indices_map`` gives the device at the same
  mesh coordinate (exactly).
* The int8 codec: ``quantize_int8``, ``ef_compress`` and the residual are
  bit-equal to JAX's; ``compressed_allreduce`` over 4 ranks is within 1e-6
  relative of JAX's under ``shard_map`` on 4 host devices.
* Distributed flash decoding along ``model`` of a ``(2, 2)`` world, with
  both shards live and with one (and one row) empty, is within 1e-5 of JAX's
  ``ref.decode_attention`` on the whole cache; the port's stats reference is
  within 1e-5 of JAX's ``return_stats=True``.
* MoE: ``_moe_forward_local`` at 2 and 4 shards, with no mesh, within 1e-5 of
  JAX's; on a ``(data=2, model=2)`` world, the local dispatch equals the
  global one within 1e-4 (aux within 1e-4), under ``train`` and
  ``train_ep2d``.
* The model on a mesh: the reduced llama's prefill and 4 decode steps under
  ``serve_tp`` and ``serve_seqkv`` (through distributed flash decoding, the
  cache's sequence cut across both ranks), and the reduced Kimi's under
  ``train`` with the local dispatch, within 1e-5 of JAX's single-device
  ``Model`` on the same weights.
* Unchanged programs: outside ``use_rules`` ``constrain`` returns its input
  itself, and the reduced llama's exported serve program holds no DTensor
  or collective node.
"""
import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_world import run_jax, run_world
from repro.dist import collectives as jcoll
from repro.dist.sharding import PRESETS as JAX_PRESETS
from repro.dist.sharding import Rules as JaxRules
from repro.kernels import ref as jref
from repro_torch.dist import collectives as tcoll
from repro_torch.dist.sharding import Rules, constrain, preset_names
from repro_torch.kernels import ref as tref

TOL = 1e-5

# ------------------------------------------------------------------- rules

AXES = ("batch", "seq", "embed", "ffn", "vocab", "heads", "head_dim", "kv_seq", "kv_heads",
        "heads_flat", "kv_flat", "experts", "expert_ffn", "layers", None)
MESHES = [{"data": 2, "model": 2}, {"data": 4, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}, {"pod": 2, "data": 2}, {"data": 8}]


def _jax_parts(spec):
    return tuple(tuple(p) if isinstance(p, tuple) else p for p in spec)


def test_preset_names_and_mappings_equal_jax():
    assert preset_names() == tuple(sorted(JAX_PRESETS))
    for name in preset_names():
        from repro_torch.dist.sharding import PRESETS
        assert PRESETS[name] == JAX_PRESETS[name]


@pytest.mark.parametrize("preset", sorted(JAX_PRESETS))
def test_spec_equals_jax_over_a_grid(preset):
    rng = np.random.default_rng(0)
    for sizes in MESHES:
        names = tuple(sizes)
        tr = Rules(preset, dict(JAX_PRESETS[preset]), names, dict(sizes))
        jr = JaxRules(preset, dict(JAX_PRESETS[preset]), names, dict(sizes))
        for _ in range(200):
            rank = int(rng.integers(1, 5))
            axes = tuple(AXES[i] for i in rng.integers(0, len(AXES), rank))
            shape = tuple(int(rng.choice([1, 2, 3, 4, 6, 8, 16, 24, 32, 48, 128, 256, 152064]))
                          for _ in range(rank))
            assert tr.spec(axes, shape) == _jax_parts(jr.spec(axes, shape)), (axes, shape)


def _rules(sizes, mapping):
    return Rules("test", mapping, tuple(sizes), dict(sizes))


MESH_SIZES = {"pod": 2, "data": 16, "model": 16}


def test_divisible_axis_assigned_and_non_divisible_dropped():
    assert _rules(MESH_SIZES, {"vocab": "model"}).spec(("vocab",), (152064,)) == ("model",)
    assert _rules(MESH_SIZES, {"kv_heads": "model"}).spec(("kv_heads",), (2,)) == (None,)


def test_fallthrough_to_head_dim():
    r = _rules(MESH_SIZES, {"kv_heads": "model", "head_dim": "model"})
    assert r.spec(("kv_heads", "head_dim"), (2, 128)) == (None, "model")
    assert r.spec(("kv_heads", "head_dim"), (16, 128)) == ("model", None)


def test_tuple_target_prefix_and_pod_dropped():
    r = _rules(MESH_SIZES, {"batch": ("pod", "data")})
    assert r.spec(("batch",), (256,)) == (("pod", "data"),)
    assert r.spec(("batch",), (2,)) == ("pod",)
    assert r.spec(("batch",), (1,)) == (None,)
    r = _rules({"data": 16, "model": 16}, {"batch": ("pod", "data")})
    assert r.spec(("batch",), (256,)) == ("data",)


def test_constrain_is_the_identity_outside_use_rules():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", "embed") is x


def test_abstract_state_is_meta_tensors_of_the_specs():
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import abstract_state
    from repro_torch.models import build_model
    from repro_torch.models.layers import is_spec
    specs = build_model(get_config("kimi-k2-1t-a32b").reduced(), 32).param_specs()
    meta = abstract_state(specs)
    want = pytree.leaves(specs, is_leaf=is_spec)
    got = pytree.leaves(meta)
    assert len(got) == len(want) > 0
    assert all(t.is_meta and tuple(t.shape) == tuple(s.shape) and t.dtype == s.dtype
               for t, s in zip(got, want))


@settings(max_examples=200, deadline=None)
@given(dim=st.integers(min_value=1, max_value=4096),
       axes=st.sampled_from(["batch", "embed", "ffn", "vocab", "kv_heads", "experts", "heads"]))
def test_property_spec_always_divides(dim, axes):
    mapping = {"batch": ("pod", "data"), "embed": "data", "ffn": "model", "vocab": "model",
               "kv_heads": "model", "experts": "model", "heads": "model"}
    part = _rules(MESH_SIZES, mapping).spec((axes,), (dim,))[0]
    if part is None:
        return
    prod = 1
    for n in ((part,) if isinstance(part, str) else part):
        prod *= MESH_SIZES[n]
    assert dim % prod == 0


@settings(max_examples=50, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=64), min_size=1, max_size=4))
def test_property_no_mesh_axis_used_twice(dims):
    mapping = {"a": "model", "b": "model", "c": ("data", "model"), "d": "data"}
    axes = ["a", "b", "c", "d"][: len(dims)]
    spec = _rules(MESH_SIZES, mapping).spec(tuple(axes), tuple(d * 16 * 32 for d in dims))
    seen = []
    for part in spec:
        if part is not None:
            seen.extend([part] if isinstance(part, str) else list(part))
    assert len(seen) == len(set(seen)), spec


# --------------------------------------------------------------- int8 codec

def test_int8_codec_and_error_feedback_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    for shape in [(33,), (4, 17), (2, 3, 5)]:
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        res = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        jq, js = jcoll.quantize_int8(jnp.asarray(x))
        tq, ts = tcoll.quantize_int8(torch.from_numpy(x))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        jq, js, jef = jcoll.ef_compress(jnp.asarray(x), jcoll.ErrorFeedback(jnp.asarray(res)))
        tq, ts, tef = tcoll.ef_compress(torch.from_numpy(x),
                                        tcoll.ErrorFeedback(torch.from_numpy(res)))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        assert np.asarray(jef.residual).tobytes() == tef.residual.numpy().tobytes()
    zero = tcoll.quantize_int8(torch.zeros(5))
    assert not zero[0].any() and float(zero[1]) > 0


# ------------------------------------------------------- flash decode refs

def _decode_inputs(lengths):
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 2, 64, 8, 2, 16
    return (rng.standard_normal((B, Hq, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("lengths", [[37, 64], [20, 0]])
def test_decode_stats_reference_matches_jax(lengths):
    q, k, v, ln = _decode_inputs(lengths)
    jm, jl, ja = jref.decode_attention(*(jnp.asarray(a) for a in (q, k, v, ln)),
                                       return_stats=True)
    tm, tl, ta = tref.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, ln)),
                                       return_stats=True)
    for j, t in ((jm, tm), (jl, tl), (ja, ta)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


# --------------------------------------------------------------- MoE, no mesh

def _moe_setup():
    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro.models.layers import init_tree as jinit
    from repro_torch.configs import get_config as tget
    jcfg = dataclasses.replace(jget("kimi-k2-1t-a32b").reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget("kimi-k2-1t-a32b").reduced(), dtype="float32")
    jp = jinit(jmoe.moe_specs(jcfg, jnp.float32), jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((8, 16, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(np.asarray, jp), x


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("capacity_factor", [100.0, 0.5])
def test_moe_local_dispatch_matches_jax_without_a_mesh(shards, capacity_factor):
    from repro.models import moe as jmoe
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import moe as tmoe
    jcfg, tcfg, jp, x = _moe_setup()
    jy, ja = jmoe._moe_forward_local(jcfg, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                     capacity_factor, shards)
    ty, ta = tmoe._moe_forward_local(tcfg, params_from_numpy(jp, device="cpu"),
                                     torch.from_numpy(x), capacity_factor, shards)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    assert abs(float(ta) - float(ja)) <= TOL


# ------------------------------------------- placements, collectives: 4 ranks

TENSORS = [(("batch", "seq", "embed"), (8, 4, 6)), (("vocab", "embed"), (16, 6)),
           (("embed", "heads_flat"), (6, 8)), (("embed", "vocab"), (6, 16)),
           (("batch", "kv_seq", "kv_heads", "head_dim"), (4, 8, 2, 4)),
           (("experts", "embed", "expert_ffn"), (4, 6, 8)), (("layers", "embed", "ffn"), (2, 6, 8))]
MESH_NAMES = [("data", "model"), ("pod", "data")]


def _jax_layouts():
    return run_jax(f"""
    import json, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.dist.sharding import make_rules, preset_names
    from repro.dist.collectives import compressed_allreduce
    from repro.launch.mesh import make_mesh
    out = {{}}
    for names in {MESH_NAMES!r}:
        mesh = make_mesh((2, 2), names)
        for preset in preset_names():
            rules = make_rules(preset, mesh)
            for i, (axes, shape) in enumerate({TENSORS!r}):
                idx = NamedSharding(mesh, rules.spec(axes, shape)).devices_indices_map(shape)
                full = np.arange(int(np.prod(shape))).reshape(shape)
                for a in range(2):
                    for b in range(2):
                        key = "/".join([*names, preset, str(i), str(2 * a + b)])
                        out[key] = full[idx[mesh.devices[a, b]]].reshape(-1).tolist()
    mesh = make_mesh((4,), ("pod",))
    x = jnp.arange(4 * 33, dtype=jnp.float32).reshape(4, 33) / 7.0 - 9.0
    f = jax.shard_map(lambda xs: compressed_allreduce(xs[0], "pod")[None], mesh=mesh,
                      in_specs=P("pod", None), out_specs=P("pod", None))
    out["allreduce"] = np.asarray(jax.jit(f)(x)[0]).tolist()
    print(json.dumps(out))
    """, 4)


def _pickle(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def test_placements_collectives_flash_decode_and_moe_on_four_ranks(tmp_path):
    """One 4-rank world: every preset's placements against JAX's device
    layout, the compressed all-reduce against JAX's under shard_map,
    distributed flash decoding against the whole-cache reference, and the
    MoE local dispatch against the global one."""
    want = _jax_layouts()
    cases = {}
    for lengths in ([37, 64], [20, 0]):
        q, k, v, ln = _decode_inputs(lengths)
        ref = np.asarray(jref.decode_attention(*(jnp.asarray(a) for a in (q, k, v, ln))))
        cases[str(lengths)] = (q, k, v, ln, ref)
    _, tcfg, jp, x = _moe_setup()
    data = _pickle(tmp_path / "data.pkl", {"cases": cases, "moe": (jp, x)})
    got = run_world(tmp_path, 4, f"""
    import pickle
    import numpy as np
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.collectives import compressed_allreduce
    from repro_torch.dist.flash_decode import decode_attention_seqsharded
    from repro_torch.dist.sharding import (make_rules, placements, preset_names, use_rules,
                                           distribute_tree, full_tree, param_shardings)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.configs import get_config
    import dataclasses
    layouts = {{}}
    for names in {MESH_NAMES!r}:
        mesh = make_mesh((2, 2), names, device="cpu")
        for preset in preset_names():
            rules = make_rules(preset, mesh)
            for i, (axes, shape) in enumerate({TENSORS!r}):
                full = torch.arange(int(np.prod(shape))).reshape(shape)
                d = distribute_tensor(full, mesh, list(placements(rules, mesh, axes, shape)),
                                      src_data_rank=None)
                layouts["/".join([*names, preset, str(i), str(RANK)])] = \\
                    d.to_local().reshape(-1).tolist()
    RESULT["layouts"] = layouts
    x = torch.arange(4 * 33, dtype=torch.float32).reshape(4, 33) / 7.0 - 9.0
    RESULT["allreduce"] = compressed_allreduce(x[RANK]).tolist()
    with open({data!r}, "rb") as f:
        data = pickle.load(f)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    RESULT["decode"] = {{}}
    for key, (q, k, v, ln, ref) in data["cases"].items():
        out = decode_attention_seqsharded(*(torch.from_numpy(a) for a in (q, k, v, ln)),
                                          mesh=mesh, axis="model")
        RESULT["decode"][key] = float(np.abs(out.full_tensor().numpy() - ref).max())
    jp, x = data["moe"]
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(), dtype="float32")
    p = params_from_numpy(jp, device="cpu")
    x = torch.from_numpy(x)
    moe = {{}}
    for preset in ("train", "train_ep2d"):
        outs = {{}}
        for disp in ("global", "local"):
            rules = make_rules(preset, mesh, moe_dispatch=disp)
            dp = distribute_tree(p, param_shardings(tmoe.moe_specs(cfg, torch.float32), rules,
                                                    mesh), mesh)
            with use_rules(rules, mesh):
                y, aux = tmoe.moe_forward(cfg, dp, x, capacity_factor=100.0)
            outs[disp] = (y.full_tensor(), float(full_tree(aux)))
        moe[preset] = [float((outs["local"][0] - outs["global"][0]).abs().max()),
                       abs(outs["local"][1] - outs["global"][1])]
    RESULT["moe"] = moe
    """)
    for r, res in enumerate(got):
        for key, vals in res["layouts"].items():
            assert vals == want[key], key
        w = np.asarray(want["allreduce"])
        rel = np.abs(np.asarray(res["allreduce"]) - w).max() / np.abs(w).max()
        assert rel <= 1e-6, (r, rel)
        for key, err in res["decode"].items():
            assert err <= TOL, (r, key, err)
        for preset, (err, aux_err) in res["moe"].items():
            assert err <= 1e-4 and aux_err <= 1e-4, (r, preset, err, aux_err)
    assert sum(len(res["layouts"]) for res in got) == len(
        [k for k in want if k != "allreduce"])


# --------------------------------------------------------- the model on a mesh

STEPS = 4


def _jax_reference(arch, prompt, capacity, seed):
    from _torch_train_ref import configs
    from repro.models import build_model as jax_build
    jcfg, _ = configs(arch)
    jm = jax_build(jcfg, capacity)
    jp = jm.init(jax.random.PRNGKey(seed))
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size, (4, prompt + STEPS),
                                                dtype=np.int32)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :prompt])}, capacity=capacity)
    out = [np.asarray(logits)]
    for t in range(STEPS):
        logits, cache = jm.decode(jp, cache, jnp.asarray(toks[:, prompt + t:prompt + t + 1]))
        out.append(np.asarray(logits))
    return jax.tree.map(np.asarray, jp), toks, out


def test_model_prefill_and_decode_on_a_mesh_match_jax(tmp_path):
    """The reduced llama under serve_tp and serve_seqkv, and the reduced
    Kimi under train with the local dispatch, on a (data=2, model=2) world."""
    cases = {"llama3.2-3b": (12, 20, ("serve_tp", "serve_seqkv")),
             "kimi-k2-1t-a32b": (12, 16, ("train",))}
    data = {arch: (*_jax_reference(arch, prompt, cap, 0), prompt, cap, presets)
            for arch, (prompt, cap, presets) in cases.items()}
    path = _pickle(tmp_path / "model.pkl", data)
    got = run_world(tmp_path, 4, f"""
    import pickle, dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import attention
    from repro_torch.dist.sharding import (make_rules, use_rules, distribute_tree,
                                           param_shardings)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    with open({path!r}, "rb") as f:
        data = pickle.load(f)
    calls = []
    merge = attention.decode_attention_seqsharded
    def counted(*a, **k):
        calls.append(1)
        return merge(*a, **k)
    attention.decode_attention_seqsharded = counted
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for arch, (jp, toks, want, prompt, cap, presets) in data.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        model = build_model(cfg, cap)
        params = params_from_numpy(jp, device="cpu")
        toks = torch.from_numpy(toks)
        for preset in presets:
            over = {{"moe_dispatch": "local"}} if cfg.moe else {{}}
            rules = make_rules(preset, mesh, **over)
            dp = distribute_tree(params, param_shardings(model.param_specs(), rules, mesh),
                                 mesh)
            calls.clear()
            with use_rules(rules, mesh), ops.impl_scope("plain"):
                logits, cache = model.prefill(dp, {{"tokens": toks[:, :prompt]}}, capacity=cap)
                errs = [float(np.abs(logits.full_tensor().numpy() - want[0]).max())]
                for t in range({STEPS}):
                    logits, cache = model.decode(dp, cache, toks[:, prompt + t:prompt + t + 1])
                    errs.append(float(np.abs(logits.full_tensor().numpy() - want[t + 1]).max()))
            RESULT[arch + "/" + preset] = {{"errs": errs, "seqsharded": len(calls)}}
    """)
    for res in got:
        for key, r in res.items():
            assert max(r["errs"]) <= TOL, (key, r)
            n_attn = 2 * STEPS                     # 2 attention layers, every step
            assert r["seqsharded"] == (n_attn if key.endswith("serve_seqkv") else 0), (key, r)


# ---------------------------------------------------------- unchanged programs

def test_the_exported_serve_program_holds_no_dtensor_or_collective():
    from repro_torch.configs import get_config
    from repro_torch.core import FunctionSpec
    from repro_torch.core.boot import fake_inputs
    from repro_torch.core.deploy import ServeProgram
    from repro_torch.models import build_model
    spec = FunctionSpec(arch="llama3.2-3b", batch_size=2, prompt_len=8, decode_steps=2)
    model = build_model(get_config("llama3.2-3b").reduced(), spec.prompt_len + spec.decode_steps)
    _, params, tokens = fake_inputs(model.param_specs(), (2, 8), "cpu")
    ep = torch.export.export(ServeProgram(model, spec), (params, tokens))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets
                            if "c10d" in t or "dtensor" in t.lower() or "redistribute" in t]
    assert any("flash_attention" in t for t in targets)
    assert json.dumps(targets)                  # plain names, nothing opaque
