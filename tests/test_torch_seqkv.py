"""Per-row decode positions in a sequence-sharded KV cache, and a serve_tp
cache cut along head_dim, against JAX.

The reduced llama (float32) on a 2-rank gloo world (``tests/_torch_world.py``)
under ``serve_seqkv``: the cache's 32 positions are cut 16 and 16 across the
two ranks. After a 21-token prefill, the cache's position is set per row to
``[3, 20]`` (one row on each rank's slice) and two decode steps run, so
every step writes through ``attention._write_local`` on both ranks and
attends through distributed flash decoding with per-row lengths. The logits
of both steps and every layer's whole K and V caches are held against the
JAX package's ``Model.decode`` on the unsharded cache with the same per-row
positions, within 1e-5 (float32 sums in another order).

Under ``serve_tp`` on 4 model ranks, the reduced qwen2.5-32b's 2 kv heads
cannot be split, so its cache is cut along ``head_dim`` (JAX's rule). Its
decode reshards the cache along the sequence by one all-to-all and runs
distributed flash decoding; prefill and two decode steps are held against
JAX's single-device ``Model`` within 1e-5.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from _torch_train_ref import configs
from _torch_world import run_world
from repro.models import build_model as jax_build

ARCH = "llama3.2-3b"
CAPACITY, PROMPT, STEPS = 32, 21, 2
POS = [3, 20]
TOL = 1e-5


def _jax_reference(arch=ARCH, pos=POS):
    jcfg, _ = configs(arch)
    jm = jax_build(jcfg, CAPACITY)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, PROMPT + STEPS),
                                             dtype=np.int32)
    _, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}, capacity=CAPACITY)
    if pos is not None:
        cache = {**cache, "pos": jnp.asarray(pos, jnp.int32)}
    logits = []
    for t in range(STEPS):
        out, cache = jm.decode(jp, cache, jnp.asarray(toks[:, PROMPT + t:PROMPT + t + 1]))
        logits.append(np.asarray(out))
    kv = {k: np.asarray(cache["inner"][k]) for k in ("k", "v")}
    return jax.tree.map(np.asarray, jp), toks, logits, kv, np.asarray(cache["pos"])


def test_per_row_positions_in_a_seq_sharded_cache_match_jax(tmp_path):
    params, toks, want_logits, want_kv, want_pos = _jax_reference()
    path = tmp_path / "seqkv.pkl"
    with open(path, "wb") as f:
        pickle.dump((params, toks, want_logits, want_kv), f)
    got = run_world(tmp_path, 2, f"""
    import pickle, dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import (distribute_tree, make_rules, param_shardings,
                                           use_rules)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, build_model
    with open({str(path)!r}, "rb") as f:
        params, toks, want_logits, want_kv = pickle.load(f)
    writes, merges = [], []
    write, merge = attention._write_local, attention.decode_attention_seqsharded
    def counted_write(cache, pos, tok):
        writes.append(not isinstance(pos, int))
        return write(cache, pos, tok)
    def counted_merge(*a, **k):
        merges.append(1)
        return merge(*a, **k)
    attention._write_local = counted_write
    attention.decode_attention_seqsharded = counted_merge
    cfg = dataclasses.replace(get_config({ARCH!r}).reduced(), dtype="float32")
    model = build_model(cfg, {CAPACITY})
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    rules = make_rules("serve_seqkv", mesh)
    dp = distribute_tree(params_from_numpy(params, device="cpu"),
                         param_shardings(model.param_specs(), rules, mesh), mesh)
    toks = torch.from_numpy(toks)
    with use_rules(rules, mesh), ops.impl_scope("plain"):
        _, cache = model.prefill(dp, {{"tokens": toks[:, :{PROMPT}]}}, capacity={CAPACITY})
        local_seq = cache["inner"]["k"].to_local().shape[2]
        cache = {{**cache, "pos": torch.tensor({POS}, dtype=torch.int32)}}
        writes.clear()
        errs = []
        for t in range({STEPS}):
            logits, cache = model.decode(dp, cache, toks[:, {PROMPT} + t:{PROMPT} + t + 1])
            errs.append(float(np.abs(logits.full_tensor().numpy() - want_logits[t]).max()))
    kv_errs = {{k: float(np.abs(cache["inner"][k].full_tensor().numpy() - want_kv[k]).max())
               for k in ("k", "v")}}
    RESULT["r"] = {{"errs": errs, "kv_errs": kv_errs, "pos": cache["pos"].tolist(),
                    "per_row_writes": sum(writes), "writes": len(writes),
                    "merges": len(merges), "local_seq": local_seq}}
    """)
    n_attn = 2 * STEPS                     # 2 attention layers (reduced), every step
    for res in got:
        r = res["r"]
        assert r["local_seq"] == CAPACITY // 2, r
        assert r["pos"] == want_pos.tolist() == [p + STEPS for p in POS], r
        assert r["per_row_writes"] == r["writes"] == 2 * n_attn, r       # K and V
        assert r["merges"] == n_attn, r
        assert max(r["errs"]) <= TOL, r
        assert max(r["kv_errs"].values()) <= TOL, r


def test_serve_tp_cache_cut_along_head_dim_decodes_as_jax(tmp_path):
    params, toks, want_logits, _, _ = _jax_reference("qwen2.5-32b", None)
    path = tmp_path / "head_dim.pkl"
    with open(path, "wb") as f:
        pickle.dump((params, toks, want_logits), f)
    got = run_world(tmp_path, 4, f"""
    import pickle, dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import (distribute_tree, make_rules, param_shardings,
                                           use_rules)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, build_model
    with open({str(path)!r}, "rb") as f:
        params, toks, want_logits = pickle.load(f)
    merges = []
    merge = attention.decode_attention_seqsharded
    def counted_merge(*a, **k):
        merges.append(a[-1])
        return merge(*a, **k)
    attention.decode_attention_seqsharded = counted_merge
    cfg = dataclasses.replace(get_config("qwen2.5-32b").reduced(), dtype="float32")
    model = build_model(cfg, {CAPACITY})
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    rules = make_rules("serve_tp", mesh)
    dp = distribute_tree(params_from_numpy(params, device="cpu"),
                         param_shardings(model.param_specs(), rules, mesh), mesh)
    toks = torch.from_numpy(toks)
    with use_rules(rules, mesh), ops.impl_scope("plain"):
        _, cache = model.prefill(dp, {{"tokens": toks[:, :{PROMPT}]}}, capacity={CAPACITY})
        placements = [str(p) for p in cache["inner"]["k"].placements]
        errs = []
        for t in range({STEPS}):
            logits, cache = model.decode(dp, cache, toks[:, {PROMPT} + t:{PROMPT} + t + 1])
            errs.append(float(np.abs(logits.full_tensor().numpy() - want_logits[t]).max()))
    RESULT["r"] = {{"errs": errs, "merges": merges, "placements": placements}}
    """)
    for res in got:
        r = res["r"]
        assert r["placements"] == ["R", "S(4)"], r             # [L,B,S,kv,hd]: head_dim
        assert r["merges"] == ["model"] * (2 * STEPS), r
        assert max(r["errs"]) <= TOL, r
