"""A whole run of each cell on the CPU at toy sizes (`toy.py`), past the
harness's look for a card: a sound program comes out correct, and one
broken underneath the timed path (`faults.py`: an answer altered where it
is produced, a manager that routes wrong) comes out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests import toy

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def run(cell, spec, tmp_path, seed=2 ** 31 + 77):
    return harness.run_cell(cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter(),
                            str(tmp_path), spec=spec)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_in_float32_is_correct(cell, tmp_path):
    spec = toy.spec(cell)
    spec["cell"]["serve"].update(compute_dtype="float32", fold_bn=False)
    line = run(cell, spec, tmp_path)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, tmp_path):
    spec = toy.spec(cell)
    spec["cell"]["serve"].update(compute_dtype="float32", fold_bn=False)
    with faults.planted("altered_normals"):
        line = run(cell, spec, tmp_path)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["rolled_manager", "manager_to_expert_0"])
def test_a_manager_that_routes_wrong_is_not_correct(fault, tmp_path):
    cell = "moe_serve_int8fold"
    spec = toy.spec(cell)
    spec["cell"]["serve"].update(compute_dtype="float32", fold_bn=False)
    with faults.planted(fault):
        line = run(cell, spec, tmp_path)
    assert not line["correct"], line["checks"]
    assert line["checks"]["id_mismatch"][0] == 0  # each file row agrees with itself
