"""Device kernels launched per served batch: the kernels in the device
trace of the window / the batches the window's jobs served."""

from portbench import trace as tmod


def read(ctx):
    tr = ctx.get("trace")
    batches = sum(j["n_batches"] for j in ctx.get("jobs") or [])
    if tr is None or not batches:
        return None
    events = tmod.clip(tr.events, ctx["t0"], ctx["t1"])
    return sum(1 for n, _, _ in events if tmod.is_kernel(n)) / batches
