"""Each cell's control, on the card: the reference at the next lower
precision than the cell serves (int4 below int8), put in the program's
place, must come out not correct.  One job at the cell's own size; about
a minute a cell."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, card):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                           "--seed", "3000000037", "--seconds", "1", "--control", "1"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is False, line["checks"]
