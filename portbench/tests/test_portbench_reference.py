"""The reference against the port at the port's reduced sizes, on the CPU:
the frozen init recipe gives the port's tensors, and the float32 forward
pass gives the port's float32 logits through prefill and decode."""
import dataclasses

import pytest
import torch

from conftest import tiny_config

from portbench.harness import spec
from portbench.harness.main import _apply
from portbench.harness.system import arch_config
from portbench.reference import weights
from portbench.reference.arch import arch_of, param_count
from portbench.reference.model import Reference, _fp8


def _configs():
    """Every configuration file, cut to the CPU's size: those of cells not in
    ``BENCHMARK.json`` yet too."""
    files = sorted((spec.HERE / "configs").glob("*.json"))
    return [_apply(c, tiny_config(c)) for c in map(spec.load_json, files)]


def _port(cfg, dtype):
    from repro_torch.models import build_model
    arch = dataclasses.replace(arch_config(cfg, reduced=True).reduced(), dtype=dtype)
    return build_model(arch, max_seq=64)


def _port_tree(params, path):
    node = params["stack"] if path.startswith("layers.") else params
    for k in path.split("."):
        node = node[k]
    return node


@pytest.mark.parametrize("cfg", _configs(), ids=lambda c: c["name"])
def test_the_frozen_init_recipe_gives_the_ports_weights(cfg):
    model = _port(cfg, "bfloat16")
    ported = model.init(torch.Generator().manual_seed(2**31 + 3))
    mine = weights.make(arch_of(cfg), 2**31 + 3, "cpu")
    from repro_torch import pytree
    assert len(mine) == len(pytree.leaves(ported))
    for path, t in mine.items():
        assert torch.equal(_port_tree(ported, path), t), path


@pytest.mark.parametrize("cfg", _configs(), ids=lambda c: c["name"])
def test_the_reference_gives_the_ports_f32_logits(cfg):
    seed, B, S, K = 11, 2, 12, 3
    model = _port(cfg, "float32")
    params = model.init(torch.Generator().manual_seed(seed))
    ref = Reference(arch_of(cfg), weights.make(arch_of(cfg), seed, "cpu", torch.float32))
    tokens = torch.randint(0, cfg["vocab_size"], (B, S + K), generator=torch.Generator()
                           .manual_seed(1), dtype=torch.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens[:, :S]}, capacity=S + K)
        ported = [logits]
        for j in range(K - 1):
            logits, cache = model.decode(params, cache, tokens[:, S + j:S + j + 1])
            ported.append(logits)
        mine = ref.logits(tokens[:, :S + K - 1], range(S - 1, S + K - 1))
    assert torch.allclose(torch.stack(ported, 1), mine, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("cfg", _configs(), ids=lambda c: c["name"])
def test_param_count_is_the_ports_tensors(cfg):
    from repro_torch import pytree
    with torch.device("meta"):
        specs = _port(cfg, "bfloat16").param_specs()
    from repro_torch.models.layers import is_spec
    n = sum(torch.Size(s.shape).numel() for s in pytree.leaves(specs, is_leaf=is_spec))
    assert param_count(arch_of(cfg)) == n


def test_param_counts_by_hand():
    olmo = spec.load_json(spec.HERE / "configs" / "olmo-1b-4L.json")
    star = spec.load_json(spec.HERE / "configs" / "starcoder2-3b-4L.json")
    # embedding 50304 x 2048; a layer 4 x 2048^2 + 3 x 2048 x 8192
    assert param_count(arch_of(olmo)) == 50304 * 2048 + 4 * (4 * 2048**2 + 3 * 2048 * 8192)
    layer = (2 * 3072 * 3072 + 2 * 3072 * 256 + 3072 + 2 * 256 + 3072
             + 2 * 3072 * 12288 + 12288 + 3072 + 4 * 3072)
    assert param_count(arch_of(star)) == 49152 * 3072 + 4 * layer + 2 * 3072


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 448.0, -3.3]])
    y = _fp8(x, dim=-1)                     # scale 1: 448 is the e4m3 maximum
    assert torch.equal(y, torch.tensor([[1.0, 1.0, 448.0, -3.25]]))
