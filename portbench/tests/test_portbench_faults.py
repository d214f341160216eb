"""A run whose timed path is broken underneath comes out not correct: the
harness's whole run but the look for a card, with each fault a served cell
can have: a token altered where it is produced, and half of the batch left
out (its rows answered with the other half's tokens). A cell here trains
nothing and spans one chip, so a state left unchanged and the exchange
between chips do not arise."""
import time

import pytest

from conftest import ROOT, cells, tiny_overrides

from portbench.harness.main import run_cell


def _altered(out):
    out[0, 0] = (out[0, 0] + 1) % 512          # the first row's first token, moved on
    return out


def _half_left_out(out):
    half = out.shape[0] // 2
    out[half:] = out[:half]                    # the second half never computed
    return out


FAULTS = {"token_altered": _altered, "half_batch_left_out": _half_left_out}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from repro_torch.core.executor import Executor
    real = Executor.run

    def broken(self, *args, **kwargs):
        return FAULTS[fault](real(self, *args, **kwargs).clone())

    monkeypatch.setattr(Executor, "run", broken)
    result, _, _ = run_cell(ROOT, cell, 2**31 + 23, 2.0, False, device="cpu", reduced=True,
                            overrides=tiny_overrides(cell), t_start=time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["correct"] is False
    check = result["checks"]["max_logit_gap"]
    assert check["value"] > check["limit"]
