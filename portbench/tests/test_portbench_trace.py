"""The trace arithmetic and the per-layer readers on a small canned trace."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench import trace as tmod
from portbench.counts.flops import int8_bound_s

# host clock, seconds: a window [10, 20] with two jobs
EVENTS = [
    ("spin_kernel(long)", 9.9, 9.95),
    ("int8_conv3d_direct_kernel", 10.0, 11.0),
    ("int8_gemm_kernel", 10.5, 12.0),  # overlaps the first
    ("Memcpy HtoD (Pageable -> Device)", 13.0, 13.5),
    ("void at::native::elementwise_kernel", 15.0, 16.0),
    ("int8_gemm_kernel", 19.5, 21.0),  # runs past the window's end
]
SPANS = [("job_setup", 10.0, 12.6), ("serving", 12.6, 15.0), ("job_setup", 15.0, 17.0),
         ("serving", 17.0, 20.0)]


class Trace:
    events = EVENTS


def ctx(**kw):
    spec = harness.cell_spec("moe_serve_int8fold", harness.benchmark())
    base = {"kind": "serve", "spec": spec, "t0": 10.0, "t1": 20.0, "spans": SPANS,
            "trace": Trace(), "serve_opts": spec["cell"]["serve"], "power_limit": "test",
            "int8_calls": [],
            "jobs": [{"n_patches": 300, "n_batches": 2, "seconds": 2.5, "wall": 5.0,
                      "expert_runs": 3, "expert_rows": [100, 0, 0, 0, 0, 0, 200]},
                     {"n_patches": 300, "n_batches": 2, "seconds": 3.0, "wall": 5.0,
                      "expert_runs": 2, "expert_rows": [0, 300, 0, 0, 0, 0, 0]}]}
    base.update(kw)
    return base


def test_busy_union_and_idle_gaps():
    ev = tmod.clip(EVENTS, 10.0, 20.0)
    assert [n for n, _, _ in ev][0] == "int8_conv3d_direct_kernel"  # marker dropped
    assert tmod.busy_intervals(ev) == [[10.0, 12.0], [13.0, 13.5], [15.0, 16.0], [19.5, 20.0]]
    assert tmod.busy_seconds(ev) == pytest.approx(4.0)
    gaps = tmod.idle_gaps(ev, 10.0, 20.0, SPANS)
    assert gaps == [("serving", pytest.approx(3.5)), ("serving", pytest.approx(1.5)),
                    ("job_setup", pytest.approx(1.0))]
    assert tmod.top_ops(ev, 2) == [("int8_gemm_kernel", pytest.approx(2.0)),
                                   ("int8_conv3d_direct_kernel", pytest.approx(1.0))]


def test_device_idle_and_launches_readers():
    assert harness.metric_reader("device_idle_pct.serve")(ctx()) == pytest.approx(60.0)
    # kernels in the window: 4 (the copy and the marker are not launches), 4 batches
    assert harness.metric_reader("launches_per_batch.serve")(ctx()) == pytest.approx(1.0)
    assert harness.metric_reader("device_idle_pct.serve")(ctx(trace=None)) is None


def test_int8_roofline_reader():
    calls = [(256, 256, 128, 5, 8), (256, 768, 256, 1, 8), (256, 1536, 1024, 1, 1)]
    got = harness.metric_reader("int8_roofline")(ctx(int8_calls=calls))
    # device time of the three int8 kernels inside the window: 1 + 1.5 + 0.5
    assert got == pytest.approx(100 * sum(int8_bound_s(*c) for c in calls) / 3.0)
    # a launch the trace lacks: nothing sound to read
    assert harness.metric_reader("int8_roofline")(ctx(int8_calls=calls[:2])) is None


def test_job_router_and_mfu_readers():
    assert harness.metric_reader("job_setup_pct.serve")(ctx()) == pytest.approx(45.0)
    assert harness.metric_reader("patches_per_expert_run")(ctx()) == pytest.approx(120.0)
    g_man, g1, g_all = 14.861, 7.100, 5.826
    flops = 100 * (g_man + g1) + 200 * (g_man + g_all) + 300 * (g_man + g1)
    want = 100 * flops * 1e9 / 10.0 / 1979e12
    assert harness.metric_reader("mfu_pct.serve")(ctx()) == pytest.approx(want, rel=1e-3)
