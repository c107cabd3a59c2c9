#!/usr/bin/env python3
"""Faults planted in the program's noise-switching model underneath the
timed path, for the switching check's rehearsals
(`tests/test_portbench_switching.py` on the CPU, this script on the card):
with any of them a run's `correct` must come out false.

  * flipped_switch: every patch's noise estimate mirrored about the
    threshold, so that every patch takes the other branch;
  * switch_to_branch_0: every patch's noise estimate 0, so that every
    patch takes branch 0 (the small radius);
  * altered_branch_normals: each normal moved by half its length where
    the branch produces it.

    python3 portbench/faults_switching.py --workload sw_serve_int8fold --fault F --seeds 11 12

runs the cell with a one-job window for each seed with `F` planted, in
one process, and prints one JSON line a seed, as `readings.py` does.
"""

from __future__ import annotations

import contextlib
import os
import sys

FAULTS = ("flipped_switch", "switch_to_branch_0", "altered_branch_normals")


def _gate(fault: str, inner):
    import torch

    from nestinet_tpu_torch.models.switching import NOISE_SWITCH_THRESHOLD

    def broken(self, grid, *a, **k):
        noise = inner(self, grid, *a, **k)  # [1, B]
        if fault == "flipped_switch":
            return 2 * NOISE_SWITCH_THRESHOLD - noise
        return torch.zeros_like(noise)

    return broken


def _branch(inner):
    def broken(self, i, grid, *a, **k):
        out = inner(self, i, grid, *a, **k)
        return out + 0.5 * out.norm(dim=1, keepdim=True)

    return broken


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with `fault` planted (none when `fault` is None)."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    from nestinet_tpu_torch.models.switching import SwitchingNormEst

    name = "expert_on_grid" if fault == "altered_branch_normals" else "gate"
    inner = getattr(SwitchingNormEst, name)
    setattr(SwitchingNormEst, name,
            _branch(inner) if fault == "altered_branch_normals" else _gate(fault, inner))
    try:
        yield
    finally:
        setattr(SwitchingNormEst, name, inner)


def main(argv=None) -> int:
    import argparse
    import json
    import shutil
    import tempfile
    import time

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from portbench import run as _run  # noqa: F401  (the cache directories, as a run sets them)
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=FAULTS, required=True)
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
            with planted(args.fault):
                line = harness.run_cell(args.workload, seed, 1e-3, False, device,
                                        time.perf_counter(), tmp, spec=spec, numbers=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": line["correct"],
                          "numbers": line["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
