"""Device time of patch extraction per served batch: the device trace's
busy time inside the device intervals of the program's `batch.extract`
spans (`infer/device_pipeline.py::extract_batch`, `ops/ball_query.py`) /
the batches served.  Printed beside it, not compared: the same figure for
the other device spans of the loop, the share of the loops' device busy
time that they cover together, the number of places where two of their
device intervals overlap, and how far each job's anchors put the device
trace from where it was placed (`spans.aligned`)."""

import sys

from portbench import spans as sp


def read(ctx):
    traces = sp.job_traces(ctx)
    batches = sum(j["n_batches"] for j in ctx.get("jobs") or [] if "trace" in j)
    if ctx.get("trace") is None or not batches:
        return None
    busy, found = sp.aligned(ctx)
    ms = {n: 1e3 * sp.length(sp.intersect(sp.merge(sp.device_intervals(traces, n)), busy))
          / batches for n in sp.LEAF_DEVICE_SPANS}
    if not sp.device_intervals(traces, "batch.extract"):
        return None
    leaves = sorted(iv for n in sp.LEAF_DEVICE_SPANS for iv in sp.device_intervals(traces, n))
    overlaps = sum(1 for x, y in zip(leaves, leaves[1:]) if y[0] < x[1])
    loops = sp.merge((s["start"], s["end"]) for t in traces for s in sp.named(t, "loop"))
    loop_busy = sp.intersect(loops, busy)
    covered = sp.length(sp.intersect(sp.merge(leaves), loop_busy))
    figures = "; ".join(f"{n} {v} ms" for n, v in ms.items())
    print(f"portbench: device ms a batch by span: {figures}; they cover "
          f"{100.0 * covered / sp.length(loop_busy)}% of the loops' device busy time "
          f"({covered} s of {sp.length(loop_busy)} s), {overlaps} overlaps", file=sys.stderr)
    fits = [f for f in found if f is not None]
    print(f"portbench: the device trace mapped onto the program's clock by the anchors' "
          f"markers in {len(fits)} of {len(found)} jobs: moved by "
          f"{min((o for o, _ in fits), default=0.0)} to {max((o for o, _ in fits), default=0.0)}"
          f" s, rates {min((1e6 * d for _, d in fits), default=0.0)} to "
          f"{max((1e6 * d for _, d in fits), default=0.0)} ppm", file=sys.stderr)
    return ms["batch.extract"]
