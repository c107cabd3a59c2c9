"""Patches a second inside the jobs' serving loops: n_patches / the jobs'
own `seconds` stat (from the first batch to the last file written), over
the window's jobs.  Steadier than `serve_patches_per_s`, which also pays
each job's set-up on the host.  Source: the program's job stats (its own
span of the loop)."""


def read(ctx):
    jobs = ctx.get("jobs") or []
    seconds = sum(j.get("seconds", 0.0) for j in jobs)
    if ctx.get("kind") != "serve" or seconds <= 0:
        return None
    return sum(j["n_patches"] for j in jobs) / seconds
