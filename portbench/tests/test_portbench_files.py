"""The harness finds every file by the names in BENCHMARK.json, a cell added
as data is picked up with no edit, the benchmark refuses to run without a
card, and nothing it runs imports JAX or the JAX package."""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "nestinet_tpu"}


def test_every_cell_config_and_metric_is_found_and_parsed():
    bench = harness.benchmark()
    assert bench["paths"] == ["portbench"] and bench["command"] == ["python3",
                                                                   "portbench/run.py"]
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert harness.load_json(os.path.join(ROOT, c["file"]))["name"] == c["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        spec = harness.cell_spec(w["name"], bench)
        assert spec["cell"]["name"] == w["name"]
        assert spec["config"]["name"] == w["config"]
        assert spec["traffic"]["name"] == w["traffic"]
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2 and spec["per_layer"]
        assert {m["moves"] for m in spec["per_layer"]} <= reported
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))


def test_a_workload_added_as_data_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = harness.benchmark()
    new = dict(bench["workloads"][0], name="moe_serve_int8fold_copy",
               why="a copy, to show that a cell is data")
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and bench["workloads"][0]["name"] in m["workloads"]:
            m["workloads"].append(new["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((root / "portbench/workloads/moe_serve_int8fold.json").read_text())
    cell["name"] = new["name"]
    (root / f"portbench/workloads/{new['name']}.json").write_text(json.dumps(cell))
    here = str(root / "portbench")
    spec = harness.cell_spec(new["name"], harness.benchmark(str(root)), here=here)
    assert spec["cell"]["name"] == new["name"]
    assert [m["name"] for m in spec["per_layer"]] == [
        m["name"] for m in harness.cell_spec("moe_serve_int8fold", harness.benchmark())
        ["per_layer"]]


FAKE_DRIVER = '''
def run(spec, seed, seconds, trace, device, t_start, tmp, control=None):
    return {"check": {"numbers": {"gap": 0.0}, "attempted": 3, "failed": 0},
            "end_to_end": {"serve_patches_per_s": 1.0, "setup_s": 2.0},
            "memory_peak_bytes": 0, "trace": None, "window": {"t0": 0.0, "t1": 1.0}}


def layer_context(spec, result):
    return {"kind": "fake"}
'''

DRIVER_RUN = r"""
import sys, time, torch
sys.path.insert(0, {root!r})
from portbench import harness
assert harness.HERE == {here!r}, harness.HERE
line = harness.run_cell("fake_cell", 1, 1.0, False, torch.device("cpu"), time.perf_counter(),
                        {root!r})
print("LINE", line["correct"], sorted(line["metrics"]), line["attempted"])
"""


def test_a_driver_added_as_a_file_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = harness.benchmark()
    bench["workloads"].append(dict(bench["workloads"][0], name="fake_cell",
                                   why="a cell of a driver added as a file"))
    for m in bench["end_to_end"]:
        m.get("workloads", []).append("fake_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "portbench/fake_driver.py").write_text(FAKE_DRIVER)
    (root / "portbench/workloads/fake_cell.json").write_text(json.dumps(
        {"name": "fake_cell", "driver": "fake_driver", "limits": {"gap": 0.1}}))
    proc = subprocess.run([sys.executable, "-c", DRIVER_RUN.format(
        root=str(root), here=str(root / "portbench"))], cwd=root, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LINE True ['serve_patches_per_s', 'setup_s'] 3" in proc.stdout


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "moe_serve_int8fold", "--seed", "1", "--seconds", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    cell = harness.benchmark()["workloads"][-1]["name"]
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                           "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _files(sub: str = "") -> list:
    files = sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"), recursive=True))
    assert files
    return files


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


@pytest.mark.parametrize("path", _files("reference"),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "nestinet_tpu_torch" not in tops and not tops & FORBIDDEN
    assert tops <= {"__future__", "math", "numpy", "torch"}, tops


BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "flax", "nestinet_tpu"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {root!r})
import time, tempfile, shutil, torch
from portbench import harness
from portbench.tests import toy
tmp = tempfile.mkdtemp()
try:
    line = harness.run_cell("moe_serve_int8fold", 5, 0.1, False, torch.device("cpu"),
                            time.perf_counter(), tmp, spec=toy.spec("moe_serve_int8fold", 8))
finally:
    shutil.rmtree(tmp)
for m in harness.cell_spec("moe_serve_int8fold", harness.benchmark())["per_layer"]:
    harness.metric_reader(m["name"])
loaded = sorted({{m.split(".")[0] for m, v in sys.modules.items() if v is not None}}
                & {{"jax", "jaxlib", "flax", "nestinet_tpu"}})
print("LOADED", loaded, line["attempted"])
"""


def test_a_run_loads_no_jax_with_them_blocked(tmp_path):
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN.format(root=ROOT)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED [] " in proc.stdout
