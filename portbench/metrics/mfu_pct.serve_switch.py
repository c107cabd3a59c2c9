"""The switching model's served step's share of the card's dense peak in
the cell's compute dtype: the window's served GFLOP (the noise CNN on
every patch plus each patch's branch, from the configuration's layer
table: `serve_switching.py::layer_context`, `counts/switching.py`) over the
window's length / the peak (`counts/peaks.py`).  The card's power limit is
printed beside it."""

import sys

from portbench.counts.peaks import PEAK_OF_DTYPE


def read(ctx):
    gflop = ctx.get("served_gflop")
    if ctx.get("kind") != "serve" or not gflop:
        return None
    rate = gflop * 1e9 / (ctx["t1"] - ctx["t0"])
    pct = 100.0 * rate / PEAK_OF_DTYPE[ctx["serve_opts"]["compute_dtype"]]
    print(f"portbench: mfu_pct.serve_switch {pct} ({rate / 1e12} TFLOP/s), card "
          f"{ctx.get('power_limit')}", file=sys.stderr)
    return pct
