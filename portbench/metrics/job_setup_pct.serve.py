"""Share of each serving job's wall time spent before and after its
serving loop (run dir load, clouds, lane budgets): (job wall time - the
job's own `seconds` stat) / job wall time, over the window's jobs.
Source: the program's job stats and the benchmark's clock."""


def read(ctx):
    jobs = ctx.get("jobs") or []
    wall = sum(j["wall"] for j in jobs)
    if ctx.get("kind") != "serve" or wall <= 0:
        return None
    return 100.0 * sum(j["wall"] - j["seconds"] for j in jobs) / wall
