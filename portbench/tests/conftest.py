"""Tests of the benchmark (not collected by the repository's own test run).

    python -m pytest -q portbench/tests            # the CPU tests, ~5 min cold
    python3 -m pytest -q -m card portbench/tests   # on a machine with one H100

The ``card`` marker: a test that needs the card; it decides inside itself
whether there is one and skips where there is none. The CPU runs of the
harness share one compile cache at a fixed path inside the checkout."""
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "portbench" / ".cache" / "cpu-tests"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips itself without one")


def need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


# The port's reduced cut (ArchConfig.reduced) of each configuration, and a
# function and gateway small enough for the CPU: what the CPU runs serve.
TINY_FN = {"batch_size": 2, "prompt_len": 16, "decode_steps": 4}


def tiny_config(config: dict) -> dict:
    """Overrides that cut configuration file ``config`` to the CPU's size."""
    kv = 4 if config["num_key_value_heads"] == config["num_attention_heads"] else 2
    return {"hidden_size": 128, "intermediate_size": 256, "num_attention_heads": 4,
            "num_key_value_heads": kv, "num_hidden_layers": 2, "vocab_size": 512,
            "real_vocab": 512, "function": TINY_FN, "check": {"max_logit_gap": 0.05}}


def tiny_overrides(cell: str) -> dict:
    from portbench.harness import spec
    c = spec.load_cell(ROOT, cell)
    traffic = {"poisson": {"rate_rps": 6.0},
               "closed": {"callers": 4},
               "mmpp": {"rate_on": 12.0, "rate_off": 2.0, "mean_on_s": 0.5, "mean_off_s": 1.0}}
    return {"config": tiny_config(c.config),
            "workload": {"gateway": {"n_hosts": 2, "slots_per_host": 2},
                         "traffic_params": traffic[c.workload["traffic_kind"]]}}


def cells():
    import json
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
