#!/usr/bin/env python3
"""The check's readings of one cell over many seeds, in one process, for
setting its limits (`workloads/<cell>.json`):

    python3 portbench/readings.py --workload <cell> --seeds 11 12 13 [--control 1] [--fault F]

on a machine with the cell's NVIDIA GPU.  Each seed is a whole run of the
cell with a one-job window (its own shapes, weights and warm-up), the
kernels built once for all of them; `--control 1` puts the cell's control
in the program's place; `--fault F` plants one of `faults.FAULTS` in the
program.  One JSON line a seed: the seed and every number the check reads,
compared or not.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from portbench import run as _run  # noqa: E402,F401  (the cache directories, as a run sets them)


def main(argv=None) -> int:
    import argparse
    import json
    import shutil
    import tempfile
    import time

    import torch

    from portbench import faults, harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", choices=faults.FAULTS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = harness.cell_spec(args.workload, harness.benchmark())
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="portbench_")
        try:
            with faults.planted(args.fault):
                line = harness.run_cell(args.workload, seed, 1e-3, False, device,
                                        time.perf_counter(), tmp, spec=spec,
                                        control=bool(args.control), numbers=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault,
                          "correct": line["correct"], "numbers": line["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
