"""Device time of the routed networks per served patch: the device
trace's busy time inside the device intervals of the program's
`router.expert` spans (each expert's or branch's run, with its gather;
`infer/predict.py::SparseMoeRouter`) / the patches the traced jobs served,
in ms.  Printed beside it, not compared: the runs and the device ms a
run."""

import sys

from portbench import spans as sp


def read(ctx):
    traces = sp.job_traces(ctx)
    runs = sp.device_intervals(traces, "router.expert")
    patches = sum(j["n_patches"] for j in ctx.get("jobs") or [] if "trace" in j)
    if ctx.get("trace") is None or not runs or not patches:
        return None
    busy, _ = sp.aligned(ctx)
    ms = 1e3 * sp.length(sp.intersect(sp.merge(runs), busy))
    print(f"portbench: routed_ms_per_patch.serve {ms / patches} over {patches} patches; "
          f"{len(runs)} runs, {ms / len(runs)} ms of device time a run", file=sys.stderr)
    return ms / patches
