"""The benchmark's harness: finds a cell's files by the names in
`BENCHMARK.json`, runs the cell's driver, reads the per-layer metrics, and
prints the result line.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by name:

  * `configs/<config>.json`: the model's sizes and layer table;
  * `traffic/<traffic>.json`: the mix, read by `traffic/generate.py`;
  * `workloads/<cell>.json`: the driver (`<driver>.py` beside this file,
    with `run` and `layer_context`), its options, the sample the check
    reads, the control and the limits of the check;
  * `metrics/<metric>.py`: `read(ctx)` returns the metric's value, or None
    where the cell gives it nothing to read.

A cell reports the end-to-end metrics whose `workloads` name it (or that
have no `workloads`), and with `--trace 1` the per-layer metrics whose
`workloads` name it (or, without `workloads`, that move an end-to-end
metric it reports).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nestinet_tpu")


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _names(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell_spec(name: str, bench: dict, here: str = HERE) -> dict:
    """Everything a run of cell `name` reads, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _names(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {
        "name": name, "workload": w, "chips": w["chips"],
        "config": load_json(os.path.join(here, "configs", w["config"] + ".json")),
        "traffic": load_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        "cell": load_json(os.path.join(here, "workloads", name + ".json")),
        "end_to_end": e2e, "per_layer": per_layer,
    }


def metric_reader(name: str, here: str = HERE):
    """The `read` function of `metrics/<name>.py`."""
    path = os.path.join(here, "metrics", name + ".py")
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    loader = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


class _Peak:
    peak = 0


@contextlib.contextmanager
def window_memory(device):
    """The device memory peak of the enclosed window, in `.peak`."""
    import torch

    mem = _Peak()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    try:
        yield mem
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize()
            mem.peak = int(torch.cuda.max_memory_allocated())


@contextlib.contextmanager
def maybe_trace(on: bool, device):
    """A `trace.DeviceTrace` of the enclosed code when `on` (the card only)."""
    if not on or device.type != "cuda":
        yield None
        return
    from .trace import DeviceTrace

    with DeviceTrace() as tr:
        yield tr


@contextlib.contextmanager
def record_int8_calls(on: bool, calls: list):
    """Record (B, cin, cout, k, r) of every launch of the program's int8
    kernels in the enclosed code: the benchmark's own span around the one
    function through which the program launches them."""
    if not on:
        yield
        return
    from nestinet_tpu_torch.ops.kernels import int8_cuda

    inner = int8_cuda.int8_conv3d_cuda

    def wrapped(x, w_q, s_w, b, kernel, *args, **kwargs):
        calls.append((x.shape[0], x.shape[1], w_q.shape[0], kernel, x.shape[2]))
        return inner(x, w_q, s_w, b, kernel, *args, **kwargs)

    int8_cuda.int8_conv3d_cuda = wrapped
    try:
        yield
    finally:
        int8_cuda.int8_conv3d_cuda = inner


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: [value, limit]} of the numbers compared): each
    number that `limits` names at or under its limit, and at least one."""
    shown = {n: [numbers.get(n), lim] for n, lim in sorted(limits.items())}
    ok = bool(limits) and all(
        v is not None and math.isfinite(v) and v <= lim for v, lim in shown.values())
    return ok, shown


def device_info(device, chips: int, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak, "power_limit": power_limit()}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             tmp: str, spec: dict | None = None, control: bool = False,
             numbers: bool = False) -> dict:
    """One run of cell `name` (its files as `cell_spec` reads them, or
    `spec`): the result line as a dict.  `control` puts the cell's control
    in the program's place; `numbers` adds every number the check read
    under "numbers" (not a key of the result line)."""
    import torch

    spec = spec or cell_spec(name, benchmark())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    driver = importlib.import_module(f"{__package__}.{spec['cell']['driver']}")
    ctl = spec["cell"]["control"] if control else None
    res = driver.run(spec, seed, seconds, trace, device, t_start, tmp, ctl)
    correct, shown = judge(res["check"]["numbers"], spec["cell"].get("limits", {}))
    metrics = {}
    if trace:
        ctx = driver.layer_context(spec, res)
        ctx["power_limit"] = power_limit() if device.type == "cuda" else "cpu"
        for m in spec["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": res["end_to_end"][m["name"]], "unit": m["unit"]}
    line = {"correct": correct, "attempted": res["check"]["attempted"],
            "failed": res["check"]["failed"], "metrics": metrics,
            "device": device_info(device, spec["chips"], res["memory_peak_bytes"])}
    tr = res["trace"]
    if tr is not None:
        from . import trace as tmod

        t0, t1 = res["window"]["t0"], res["window"]["t1"]
        events = tmod.clip(tr.events, t0, t1)
        line["device"]["busy_s"] = tmod.busy_seconds(events)
        line["device"]["window_s"] = t1 - t0
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in tmod.top_ops(events)],
            "idle_gaps": [[n, s] for n, s in tmod.idle_gaps(events, t0, t1, res["spans"])[:10]],
        }
    for n, value in sorted(res["check"]["numbers"].items()):
        if n not in shown:
            log(f"reading {n}: {value} (not compared)")
    for n, (value, limit) in shown.items():
        log(f"check {n}: {value} (limit {limit})")
    if numbers:
        line["numbers"] = res["check"]["numbers"]
    line["checks"] = shown
    return line
