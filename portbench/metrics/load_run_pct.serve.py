"""Share of the jobs spent loading the run dir: the program's `load_run`
spans / its `job` spans (`infer/predict.py::load_run`, the whole call on
the rank).  Printed beside it, not compared: the seconds a job of each
`load_run.*` part, of `clouds` and of `caps`, and the share of the jobs'
set-up on the benchmark's clock (wall time less the `seconds` stat) that
the program's set-up spans (`job` less `loop`) cover."""

import sys

from portbench import spans as sp

PARTS = ("load_run.build", "load_run.read", "load_run.load_state", "load_run.fold",
         "load_run.quantize", "load_run.upload", "clouds", "caps")


def span_seconds(trace, name) -> float:
    return sum(s["end"] - s["start"] for s in sp.named(trace, name))


def read(ctx):
    jobs = [j for j in ctx.get("jobs") or [] if "trace" in j]
    job_s = sum(span_seconds(j["trace"], "job") for j in jobs)
    if ctx.get("kind") != "serve" or job_s <= 0:
        return None
    pct = 100.0 * sum(span_seconds(j["trace"], "load_run") for j in jobs) / job_s
    parts = "; ".join(f"{n} {sum(span_seconds(j['trace'], n) for j in jobs) / len(jobs)} s"
                      for n in PARTS)
    setup = sum(j["wall"] - j["seconds"] for j in jobs)
    spans = sum(span_seconds(j["trace"], "job") - span_seconds(j["trace"], "loop")
                for j in jobs)
    print(f"portbench: load_run_pct.serve {pct}; a job's parts: {parts}", file=sys.stderr)
    print(f"portbench: set-up spans cover {100.0 * spans / setup}% of the jobs' set-up "
          f"({spans} s of {setup} s)", file=sys.stderr)
    return pct
