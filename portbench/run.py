#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's NVIDIA GPUs.
It measures `nestinet_tpu_torch` only, and fails, printing no result,
without a card, with fewer cards than the cell asks for, without the
program beside it, or when JAX, flax or the JAX package were loaded.  The
last line of standard output is the result as one JSON object; the
numbers the check compared, each beside its limit, end standard error.
`--control 1` puts the cell's control, the reference at the next lower
precision, in the program's place (the check must then fail); the driver
never passes it.

Inputs, weights and outputs of a run live in a fresh directory under
TMPDIR, removed at the end; the kernels' build caches in fixed directories
of the checkout (`nestinet_tpu_torch/_build/`, `portbench/_cache/`).
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    import json
    import shutil
    import tempfile

    args = parse(argv)
    from portbench import harness

    try:
        spec = harness.cell_spec(args.workload, harness.benchmark())
    except (OSError, KeyError, ValueError) as e:
        harness.log(f"cannot read the cell: {e}")
        return 2
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark measures the card and runs nowhere else")
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        harness.log(f"the cell needs {spec['chips']} GPUs, {torch.cuda.device_count()} visible")
        return 2
    if importlib_missing("nestinet_tpu_torch"):
        harness.log("the program nestinet_tpu_torch is not in this checkout")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    harness.log(f"{args.workload} seed {args.seed}: {harness.power_limit()}")
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                device, T_START, tmp, spec=spec, control=bool(args.control))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    print(json.dumps(line), flush=True)
    return 0


def importlib_missing(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is None


if __name__ == "__main__":
    sys.exit(main())
