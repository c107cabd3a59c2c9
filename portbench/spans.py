"""The program's own spans and counters of a `--trace 1` run, beside the
device trace.

Each serving job recorded under the profiler returns `trace` in its stats
(`nestinet_tpu_torch/core/profiling.py`): spans {name, id, parent, job,
start, end} on the host's `time.perf_counter` clock, device spans also
{device_start, device_end} on the same clock, counters, and on a CUDA
device the host times of the job's two anchors.  The program launches a
marker kernel (`torch.cuda._sleep`, as `trace.py` does) right before each
anchor's event, so the marker's end in the device trace and the anchor's
host time are one instant: the two markers of a job map the trace onto
the program's clock exactly, offset and drift (`aligned`).  The trace's
own placement, one marker a window, missed by 80-480 us on an NVIDIA H100
and drifted up to 30 ppm.  Intervals below are sorted, disjoint (start,
end) pairs.
"""

from __future__ import annotations

import bisect
import collections

from portbench import trace as tmod

# the device spans that enqueue the serving loop's device work, one after another
LEAF_DEVICE_SPANS = ("grids", "batch.extract", "batch.mups", "batch.model", "router.expert")


def job_traces(ctx) -> list:
    """The `trace` of every job of the window that recorded one."""
    if ctx.get("kind") != "serve":
        return []
    return [j["trace"] for j in ctx.get("jobs") or [] if "trace" in j]


def named(trace: dict, name: str) -> list:
    return [s for s in trace["spans"] if s["name"] == name]


def aligned(ctx) -> tuple:
    """(the device's busy intervals inside the jobs' loops, on the program's
    clock; [(offset, drift)] of each job: where its anchors lie from the
    trace's markers, seconds, and the program's clock's rate over the
    trace's, less 1; None where the trace is taken as placed).  The jobs'
    markers are the trace's last two a job, in order (the trace's own comes
    before every job); where the trace holds too few, or the jobs recorded
    no anchors (on the CPU), the trace is taken as placed."""
    events = ctx["trace"].events
    raw = [tuple(b) for b in tmod.busy_intervals(tmod.clip(events, ctx["t0"], ctx["t1"]))]
    ends = sorted(b for n, _, b in events if tmod.MARKER in n)
    traces = job_traces(ctx)
    n = 2 * sum(1 for t in traces if "anchors" in t)
    ends = ends[len(ends) - n:] if len(ends) >= n else []
    marks = iter(zip(ends[::2], ends[1::2]))
    out, fits = [], []
    for t in traces:
        loops = merge((s["start"], s["end"]) for s in named(t, "loop"))
        m0, m1 = next(marks, (None, None)) if "anchors" in t else (None, None)
        if m0 is None:
            out += intersect(raw, loops)
            fits.append(None)
            continue
        h0, h1 = t["anchors"]
        scale = (h1 - h0) / (m1 - m0)
        near = raw[max(bisect.bisect_left(raw, (m0,)) - 1, 0):bisect.bisect_right(raw, (m1,))]
        out += intersect([(h0 + (a - m0) * scale, h0 + (b - m0) * scale) for a, b in near], loops)
        fits.append((h0 - m0, scale - 1.0))
    return out, fits


def busy(ctx) -> list:
    return aligned(ctx)[0]


def self_intervals(spans: list) -> dict:
    """{span id: [(start, end), ...]}: each span's host interval less the
    parts its child spans cover (its self time), the children clipped to
    it.  Over one tree the intervals partition the root's."""
    children = collections.defaultdict(list)
    for s in spans:
        if s["parent"] is not None:
            children[s["parent"]].append(s)
    out = {}
    for s in spans:
        at, end, own = s["start"], s["end"], []
        for c in sorted(children[s["id"]], key=lambda c: c["start"]):
            if c["start"] > at:
                own.append((at, min(c["start"], end)))
            at = max(at, min(c["end"], end))
        if end > at:
            own.append((at, end))
        out[s["id"]] = own
    return out


def intersect(xs, ys) -> list:
    """The intersection of two lists of sorted, disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def split(labelled, intervals) -> dict:
    """{label: the length of `intervals` inside that label's parts}, for
    sorted, disjoint (start, end, label) parts."""
    out, i, j = {}, 0, 0
    while i < len(labelled) and j < len(intervals):
        a, b = max(labelled[i][0], intervals[j][0]), min(labelled[i][1], intervals[j][1])
        if b > a:
            out[labelled[i][2]] = out.get(labelled[i][2], 0.0) + b - a
        if labelled[i][1] < intervals[j][1]:
            i += 1
        else:
            j += 1
    return out


def gaps(busy_iv, a: float, b: float) -> list:
    """The idle stretches of [a, b]: its parts that no busy interval covers."""
    k = max(bisect.bisect_right(busy_iv, (a, float("inf"))) - 1, 0)
    out, at = [], a
    for s, e in busy_iv[k:]:
        if s >= b:
            break
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if b > at:
        out.append((at, b))
    return out


def subtree(trace: dict, root: dict) -> list:
    """`root` and every span under it."""
    kids = {}
    for s in trace["spans"]:
        kids.setdefault(s["parent"], []).append(s)
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out.append(s)
        todo += kids.get(s["id"], [])
    return out


def device_intervals(traces, name: str) -> list:
    """The device intervals of every span `name`, sorted."""
    return sorted((s["device_start"], s["device_end"]) for t in traces for s in named(t, name)
                  if "device_start" in s)


def merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
