"""The check's control comes out not correct: the reference put in the
program's place in float8, the precision below the served bfloat16, picks
tokens whose gap below the float32 reference's best passes the limit, where
the program's served tokens stay within it. On the CPU at the port's
reduced sizes, against the reduced runs' limit; on the card at each cell's
own size, against its configuration's limit."""
import time

import pytest

from conftest import ROOT, cells, need_card, tiny_overrides

from portbench.harness import spec
from portbench.harness.main import prepare, run_cell
from portbench.tools.control import readings


def _one_per_config():
    seen = {}
    for cell in cells():
        seen.setdefault(spec.load_cell(ROOT, cell).config["name"], cell)
    return list(seen.values())


@pytest.mark.parametrize("cell", _one_per_config())
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_where_the_program_passes_reduced(cell, seed):
    over = tiny_overrides(cell)
    _, _, run = run_cell(ROOT, cell, seed, 1.5, False, device="cpu", reduced=True,
                         overrides=over, t_start=time.perf_counter(), log=lambda m: None)
    got = readings(run, seed, "cpu")
    limit = over["config"]["check"]["max_logit_gap"]
    assert got["f32"] <= limit < got["fp8"]


@pytest.mark.card
@pytest.mark.parametrize("cell", _one_per_config())
def test_control_fails_where_the_program_passes_on_the_card(cell):
    need_card()
    assert prepare(ROOT, 1) is None
    _, _, run = run_cell(ROOT, cell, 2**31 + 101, 5.0, False, t_start=time.perf_counter())
    got = readings(run, 2**31 + 101, "cuda")
    limit = run.cell.config["check"]["max_logit_gap"]
    assert got["f32"] <= limit < got["fp8"]
