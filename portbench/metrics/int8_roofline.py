"""The int8 kernels' share of their roofline (`csrc/int8_conv.cu`,
`csrc/int8_gemm.cu`): the sum over the window's launches of each launch's
bound (`counts/flops.py::int8_bound_s`, from the shapes the benchmark
recorded at the program's one launching function) / the sum of those
kernels' device time in the trace.  Against the published H100 peaks; the
card's power limit is printed beside it."""

import sys

from portbench import trace as tmod
from portbench.counts.flops import int8_bound_s

NAMES = ("int8_conv3d", "int8_gemm")


def read(ctx):
    tr, calls = ctx.get("trace"), ctx.get("int8_calls") or []
    if tr is None or not calls:
        return None
    events = [e for e in tmod.clip(tr.events, ctx["t0"], ctx["t1"])
              if any(k in e[0] for k in NAMES)]
    device_s = sum(b - a for _, a, b in events)
    if len(events) != len(calls) or device_s <= 0:
        print(f"portbench: int8_roofline: {len(events)} int8 kernels in the trace, "
              f"{len(calls)} launches recorded: nothing sound to read", file=sys.stderr)
        return None
    pct = 100.0 * sum(int8_bound_s(*c) for c in calls) / device_s
    print(f"portbench: int8_roofline {pct} over {len(calls)} launches "
          f"({device_s} s of device time), card {ctx.get('power_limit')}", file=sys.stderr)
    return pct
