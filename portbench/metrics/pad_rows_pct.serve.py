"""Share of the rows run through a routed network that are padding: the
jobs' `pad_rows` counter (the rows added to runs of fewer than B rows,
`infer/predict.py::SparseMoeRouter`) / (the patches served + those rows),
every served patch running through exactly one routed network.  None
where the program counts no `pad_rows`."""


def read(ctx):
    jobs = [j for j in ctx.get("jobs") or [] if "trace" in j]
    if ctx.get("kind") != "serve" or not any("pad_rows" in j["trace"]["counters"] for j in jobs):
        return None
    pad = sum(j["trace"]["counters"].get("pad_rows", 0) for j in jobs)
    return 100.0 * pad / (pad + sum(j["n_patches"] for j in jobs))
