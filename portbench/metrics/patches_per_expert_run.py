"""Patches served per expert run of the router
(`infer/predict.py::SparseMoeRouter`): n_patches / expert_runs over the
window's jobs.  Source: the program's job stats (counters)."""


def read(ctx):
    jobs = ctx.get("jobs") or []
    runs = sum(j.get("expert_runs", 0) for j in jobs)
    if not runs:
        return None
    return sum(j["n_patches"] for j in jobs) / runs
