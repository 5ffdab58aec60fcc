"""The comparison that decides ``correct`` on small cells: a sound run
passes the cell's limits; each control in the program's place (fp8 on
the CPU; TF32 exists on the card only) and each fault the cell can have,
planted in the program underneath the harness, fail them. The runs go
through ``harness.run`` past its look for a card."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests.small import small, small_cell

SERVE = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]


def run_small(name: str, device="cpu") -> dict:
    result, _ = harness.run(name, 3, 0.5, False, torch.device(device),
                            time.perf_counter(), 1, spec=small(name))
    return result


@pytest.mark.parametrize("name", SERVE)
def test_sound_run_is_correct(name):
    result = run_small(name)
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "compared"


def control_verdict(name: str, control: str, device) -> bool:
    spec, cell = small_cell(name, device=device)
    cell.release()
    correct, _, _ = harness.verdict(cell.compare(control),
                                    spec["cell"]["limits"])
    return correct


@pytest.mark.parametrize("name", SERVE)
def test_fp8_control_is_not_correct(name):
    assert not control_verdict(name, "fp8", torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVE)
def test_tf32_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("TF32 runs on the card only")
    assert not control_verdict(name, "tf32", torch.device("cuda", 0))


@pytest.mark.parametrize("fault", sorted(faults.ALL))
@pytest.mark.parametrize("name", SERVE)
def test_serving_fault_is_not_correct(monkeypatch, name, fault):
    faults.ALL[fault](monkeypatch)
    result = run_small(name)
    assert not result["correct"] and result["failed"] > 0
