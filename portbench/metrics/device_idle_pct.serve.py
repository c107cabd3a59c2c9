"""Share of the serving window in which nothing runs on the device: one
minus the union of the trace's kernel, copy and fill intervals over the
window's length."""

from portbench import trace as tmod


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or ctx.get("kind") != "serve":
        return None
    t0, t1 = ctx["t0"], ctx["t1"]
    return 100.0 * (1.0 - tmod.busy_seconds(tmod.clip(tr.events, t0, t1)) / (t1 - t0))
