"""The host's waits on the device per served batch: the jobs' `host_syncs`
counter (every `fetch` of a device tensor and every `upload` of a host
value in the serving loop, `core/profiling.py`) / the batches they served.
Printed beside it, not compared: the waits per batch by span name."""

import sys

from portbench import spans as sp


def read(ctx):
    jobs = [j for j in ctx.get("jobs") or [] if "trace" in j]
    batches = sum(j["n_batches"] for j in jobs)
    if ctx.get("kind") != "serve" or not batches:
        return None
    syncs = sum(j["trace"]["counters"].get("host_syncs", 0) for j in jobs)
    by_name = {}
    for j in jobs:
        for s in j["trace"]["spans"]:
            if s["name"].startswith(("fetch.", "upload.")):
                by_name[s["name"]] = by_name.get(s["name"], 0) + 1
    names = ", ".join(f"{n} {c / batches}" for n, c in sorted(by_name.items()))
    print(f"portbench: host_syncs_per_batch.serve {syncs / batches} over {batches} batches; "
          f"per batch by span: {names}", file=sys.stderr)
    return syncs / batches
