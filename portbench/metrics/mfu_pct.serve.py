"""The whole served step's share of the card's dense peak in the cell's
compute dtype: patches/s over the window x the GFLOP a served patch needs
(the manager plus the expert the router chose, weighted by the patches
each expert served, or the MS network; `counts/flops.py`) / the peak
(`counts/peaks.py`).  The card's power limit is printed beside it."""

import sys

from portbench.counts.flops import gflop_per_patch
from portbench.counts.peaks import PEAK_OF_DTYPE


def read(ctx):
    jobs = ctx.get("jobs") or []
    if ctx.get("kind") != "serve" or not jobs:
        return None
    cfg = ctx["spec"]["config"]
    g = gflop_per_patch(cfg)
    flops = 0.0
    for j in jobs:
        if "expert_rows" in j:
            flops += sum(n * (g["manager"] + g[f"expert{e}"])
                         for e, n in enumerate(j["expert_rows"])) * 1e9
        else:
            flops += j["n_patches"] * g["net"] * 1e9
    rate = flops / (ctx["t1"] - ctx["t0"])
    pct = 100.0 * rate / PEAK_OF_DTYPE[ctx["serve_opts"]["compute_dtype"]]
    print(f"portbench: mfu_pct.serve {pct} ({rate / 1e12} TFLOP/s), card "
          f"{ctx.get('power_limit')}", file=sys.stderr)
    return pct
