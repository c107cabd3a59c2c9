"""Share of the program's serving loops (the `loop` spans of the jobs'
traces, `infer/device_pipeline.py`) in which nothing runs on the device:
no kernel, copy or fill of the device trace.  Printed beside it, not
compared: the loops' idle time split by the innermost program span open on
the host at each idle instant (the `loop`'s own self time included), and by
the length of the idle stretch (short ones: launch-bound; long ones: host
work or waits)."""

import sys

from portbench import spans as sp

LENGTHS = ((1e-5, "under 10 us"), (1e-4, "10-100 us"), (1e-3, "0.1-1 ms"),
           (float("inf"), "1 ms or more"))


def read(ctx):
    traces = sp.job_traces(ctx)
    if ctx.get("trace") is None or not traces:
        return None
    busy = sp.busy(ctx)
    loop_s = idle_s = 0.0
    by_span, by_length = {}, {label: [0, 0.0] for _, label in LENGTHS}
    for t in traces:
        for loop in sp.named(t, "loop"):
            idle = sp.gaps(busy, loop["start"], loop["end"])
            loop_s += loop["end"] - loop["start"]
            idle_s += sp.length(idle)
            for a, b in idle:
                cell = by_length[next(label for top, label in LENGTHS if b - a < top)]
                cell[0] += 1
                cell[1] += b - a
            tree = sp.subtree(t, loop)
            name = {s["id"]: s["name"] for s in tree}
            own = sorted((a, b, name[i]) for i, parts in sp.self_intervals(tree).items()
                         for a, b in parts)
            for label, seconds in sp.split(own, idle).items():
                by_span[label] = by_span.get(label, 0.0) + seconds
    if loop_s <= 0:
        return None
    pct = 100.0 * idle_s / loop_s
    spans = "; ".join(f"{n} {s} s ({100.0 * s / idle_s}%)"
                      for n, s in sorted(by_span.items(), key=lambda kv: -kv[1]))
    lengths = "; ".join(f"{label}: {n} gaps, {s} s ({100.0 * s / idle_s}%)"
                        for label, (n, s) in by_length.items())
    print(f"portbench: loop_idle_pct.serve {pct}: {idle_s} s idle of {loop_s} s in "
          f"the loops of {len(traces)} jobs", file=sys.stderr)
    print(f"portbench: loop idle by innermost span: {spans}", file=sys.stderr)
    print(f"portbench: loop idle by gap length: {lengths}", file=sys.stderr)
    return pct
