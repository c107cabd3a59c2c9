"""The readers of the program's spans and counters on a canned trace, and,
on the card, one job of each cell held to the device trace and to CUDA's
own count of the host's waits."""

from __future__ import annotations

import os
import tempfile
import time
import warnings

import pytest

from portbench import harness
from portbench import spans as sp

# host clock, seconds: one job in a window [10, 20]
EVENTS = [
    ("spin_kernel(long)", 9.9, 9.95),
    ("Memcpy HtoD (Pageable -> Device)", 11.0, 11.5),  # load_run's upload
    ("build_grid_kernel", 12.7, 13.1),
    ("ball_query_kernel", 13.2, 14.5),
    ("tdmfv_n_est_kernel", 14.5, 15.2),
    ("int8_conv3d_direct_kernel", 15.6, 16.5),
    ("int8_gemm_kernel", 16.7, 17.4),
    ("Memset (Device)", 18.0, 18.2),  # under no device span
]


def span(i, parent, name, a, b, dev=None):
    s = {"name": name, "id": i, "parent": parent, "job": 3, "start": a, "end": b}
    if dev:
        s["device_start"], s["device_end"] = dev
    return s


SPANS = [
    span(0, None, "job", 10.0, 19.0),
    span(1, 0, "load_run", 10.0, 12.0),
    span(2, 1, "load_run.build", 10.0, 11.0),
    span(3, 1, "load_run.read", 11.0, 11.5),
    span(4, 0, "clouds", 12.0, 12.2),
    span(5, 0, "caps", 12.2, 12.5),
    span(6, 0, "loop", 12.5, 19.0),
    span(7, 6, "shape", 12.5, 13.0),
    span(8, 7, "grids", 12.6, 13.0, (12.7, 13.1)),
    span(9, 6, "batch.extract", 13.0, 14.0, (13.1, 14.5)),
    span(10, 9, "upload.queries", 13.0, 13.1),
    span(11, 6, "batch.mups", 14.0, 15.0, (14.5, 15.5)),
    span(12, 6, "batch.model", 15.0, 16.0, (15.5, 16.5)),
    span(13, 6, "router.commit", 16.0, 18.0),
    span(14, 13, "fetch.probs", 16.0, 16.6),
    span(15, 13, "router.expert", 16.6, 17.0, (16.6, 17.5)),
    span(16, 13, "fetch.normals", 17.0, 17.5),
    span(17, 6, "outputs.finish", 18.5, 19.0),
]


class Trace:
    events = EVENTS


def ctx(jobs=None, **kw):
    spec = harness.cell_spec("moe_serve_int8fold", harness.benchmark())
    job = {"n_patches": 256, "n_batches": 1, "seconds": 6.5, "wall": 10.0,
           "trace": {"spans": SPANS, "counters": {"host_syncs": 3}}}
    base = {"kind": "serve", "spec": spec, "t0": 10.0, "t1": 20.0, "spans": [],
            "trace": Trace(), "serve_opts": spec["cell"]["serve"], "power_limit": "test",
            "int8_calls": [], "jobs": [job] if jobs is None else jobs}
    base.update(kw)
    return base


NEW = ("loop_idle_pct.serve", "host_syncs_per_batch.serve", "load_run_pct.serve",
       "extract_ms_per_batch.serve")


def test_interval_arithmetic():
    busy = [(1.0, 2.0), (3.0, 5.0), (6.0, 7.0)]
    assert sp.gaps(busy, 1.5, 6.5) == [(2.0, 3.0), (5.0, 6.0)]
    assert sp.gaps(busy, 0.0, 1.0) == [(0.0, 1.0)]
    assert sp.intersect(busy, [(1.5, 3.5), (4.0, 6.5)]) == [(1.5, 2.0), (3.0, 3.5), (4.0, 5.0),
                                                            (6.0, 6.5)]
    assert sp.split([(0.0, 2.5, "a"), (2.5, 8.0, "b")], busy) == {"a": 1.0, "b": 3.0}
    assert sp.merge([(3.0, 4.0), (1.0, 2.0), (1.5, 2.5)]) == [(1.0, 2.5), (3.0, 4.0)]


def test_the_trace_is_mapped_onto_the_program_clock_by_the_anchor_markers():
    """A trace placed 300 us early, and 30 us a second more (the two clocks
    drifting), is put back where the program's device spans are by the
    markers of the job's two anchors; the trace's own marker, first, is
    left out."""
    def placed(t):  # where the trace puts a device instant t of the program's clock
        return t - 3e-4 - 30e-6 * (t - 99.0)

    spans, events = [span(0, None, "loop", 99.9, 103.0)], [("spin_kernel", 98.0, 98.001)]
    for i in range(250):
        t = 100.0 + 0.01 * i
        spans.append(span(i + 1, 0, "batch.extract", t, t + 0.002, (t + 1e-4, t + 0.004)))
        # the span's kernels, with a 20 us gap inside, then the card idle
        events += [("k", placed(t + 1e-4), placed(t + 0.002)),
                   ("k", placed(t + 0.00202), placed(t + 0.004))]
    events += [("spin_kernel", placed(99.0) - 1e-6, placed(99.0)),
               ("spin_kernel", placed(104.0) - 1e-6, placed(104.0))]
    c = {"kind": "serve", "trace": type("T", (), {"events": events}), "t0": 98.5, "t1": 104.5,
         "jobs": [{"n_batches": 250,
                   "trace": {"spans": spans, "counters": {}, "anchors": [99.0, 104.0]}}]}
    busy, [(offset, drift)] = sp.aligned(c)
    assert offset == pytest.approx(3e-4, abs=1e-9)
    assert drift == pytest.approx(30e-6 / (1 - 30e-6), rel=1e-6)
    assert busy[0] == pytest.approx((100.0001, 100.002), abs=1e-9)
    leaves = sp.device_intervals(sp.job_traces(c), "batch.extract")
    assert sp.length(sp.intersect(leaves, busy)) == pytest.approx(sp.length(busy), rel=1e-9)
    assert sp.length(busy) == pytest.approx(250 * (0.0039 - 2e-5), rel=1e-6)
    # without the job's two markers, the trace stays where it was placed
    c["trace"].events = events[:-2]
    busy, fits = sp.aligned(c)
    assert fits == [None] and busy[0] == pytest.approx((placed(100.0001), placed(100.002)))


def test_self_intervals_on_a_hand_built_tree():
    def s(i, parent, a, b):
        return {"name": f"s{i}", "id": i, "parent": parent, "job": 0, "start": a, "end": b}

    spans = [s(0, None, 0.0, 10.0), s(1, 0, 1.0, 3.0), s(2, 1, 1.5, 2.0), s(3, 0, 3.0, 6.0),
             s(4, 0, 8.0, 10.0), s(5, 3, 5.5, 6.5)]  # 5 runs past its parent's end
    own = sp.self_intervals(spans)
    assert own == {0: [(0.0, 1.0), (6.0, 8.0)], 1: [(1.0, 1.5), (2.0, 3.0)], 2: [(1.5, 2.0)],
                   3: [(3.0, 5.5)], 4: [(8.0, 10.0)], 5: [(5.5, 6.5)]}
    # the self intervals of a tree that nests partition its root
    nested = spans[:5]
    total = sum(b - a for parts in sp.self_intervals(nested).values() for a, b in parts)
    assert total == pytest.approx(10.0)


def test_loop_idle_reader(capsys):
    # busy in the loop 4.2 s of 6.5: idle 0.2 + 0.1 + 0.4 + 0.2 + 0.6 + 0.8
    assert harness.metric_reader("loop_idle_pct.serve")(ctx()) == pytest.approx(100 * 2.3 / 6.5)
    err = capsys.readouterr().err
    by_span = dict(part.split(" ")[:2] for part in
                   err.split("loop idle by innermost span: ")[1].splitlines()[0].split("; "))
    want = {"outputs.finish": 0.5, "router.commit": 0.5, "batch.model": 0.4, "loop": 0.3,
            "shape": 0.1, "grids": 0.1, "batch.extract": 0.1, "fetch.probs": 0.1,
            "router.expert": 0.1, "fetch.normals": 0.1}
    assert {k: float(v) for k, v in by_span.items()} == pytest.approx(want)
    assert "1 ms or more: 6 gaps" in err and "under 10 us: 0 gaps" in err


def test_host_syncs_load_run_and_extract_readers(capsys):
    c = ctx()
    assert harness.metric_reader("host_syncs_per_batch.serve")(c) == pytest.approx(3.0)
    assert harness.metric_reader("load_run_pct.serve")(c) == pytest.approx(100 * 2.0 / 9.0)
    # device busy inside batch.extract's device interval [13.1, 14.5]: 1.3 s
    assert harness.metric_reader("extract_ms_per_batch.serve")(c) == pytest.approx(1300.0)
    err = capsys.readouterr().err
    assert "fetch.normals 1.0, fetch.probs 1.0, upload.queries 1.0" in err
    assert "load_run.build 1.0 s; load_run.read 0.5 s" in err
    spans, setup = 9.0 - 6.5, 10.0 - 6.5
    assert f"set-up spans cover {100.0 * spans / setup}%" in err
    # the leaves cover 0.4 + 1.3 + 0.7 + 0.9 + 0.7 of the loop's 4.2 busy seconds
    covered = err.split("they cover ")[1].split("%")[0]
    assert float(covered) == pytest.approx(100 * 4.0 / 4.2)
    assert ", 0 overlaps" in err


@pytest.mark.parametrize("name", NEW)
def test_a_parent_without_spans_reads_nothing(name):
    """The program of the parent commit records no spans: every new reader
    returns None, and raises nothing."""
    bare = [{"n_patches": 256, "n_batches": 1, "seconds": 6.5, "wall": 10.0}]
    assert harness.metric_reader(name)(ctx(jobs=bare)) is None
    assert harness.metric_reader(name)(ctx(jobs=[])) is None


@pytest.fixture(scope="module", params=["moe_serve_int8fold", "ms_serve_bf16"])
def served(request):
    """One job of the cell at its own size under the benchmark's device
    trace, with CUDA's sync debug mode warning: (the job, the trace, the
    host times of the sync warnings)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the job runs on the card)")
    from portbench import serve
    from portbench.trace import DeviceTrace

    spec = harness.cell_spec(request.param, harness.benchmark())
    stamps = []

    def stamp(message, *args, **kwargs):
        if "synchronizing CUDA operation" in str(message):
            stamps.append(time.perf_counter())

    with tempfile.TemporaryDirectory() as tmp:
        setup = serve.Setup(spec, 2300000001, tmp, torch.device("cuda", 0))
        opts = spec["cell"]["serve"]
        setup.warm_up(opts)
        with warnings.catch_warnings(), DeviceTrace() as tr:
            warnings.simplefilter("always")
            warnings.showwarning = stamp
            torch.cuda.set_sync_debug_mode("warn")
            try:
                job = setup.job(opts, os.path.join(tmp, "out"))
            finally:
                torch.cuda.set_sync_debug_mode(0)
    return job, tr, stamps


@pytest.mark.card
def test_every_host_wait_of_the_loop_is_counted(served):
    """The sync warnings raised while the job's `loop` span is open equal
    its `host_syncs`, and no device span starts on the card more than 50 us
    before the host entered it."""
    job, _, stamps = served
    trace = job["stats"]["trace"]
    (loop,) = sp.named(trace, "loop")
    inside = sum(1 for t in stamps if loop["start"] <= t <= loop["end"])
    assert inside == trace["counters"]["host_syncs"] > 0
    early = min(s["device_start"] - s["start"] for s in trace["spans"] if "device_start" in s)
    assert early > -5e-5, early


@pytest.mark.card
def test_the_leaf_device_spans_cover_the_loop(served):
    """The job's leaf device spans do not overlap and cover at least 98% of
    the loop's device busy time, the trace mapped onto the program's clock
    by the job's anchor markers, as the readers map it."""
    job, tr, _ = served
    trace = job["stats"]["trace"]
    (loop,) = sp.named(trace, "loop")
    c = {"kind": "serve", "trace": tr, "t0": job["start"], "t1": job["end"],
         "jobs": [job["stats"]]}
    busy, fits = sp.aligned(c)
    assert fits != [None]  # the job's two anchor markers are in the trace
    loop_busy = sp.intersect([(loop["start"], loop["end"])], busy)
    leaves = sorted(iv for n in sp.LEAF_DEVICE_SPANS for iv in sp.device_intervals([trace], n))
    assert all(y[0] >= x[1] for x, y in zip(leaves, leaves[1:]))
    covered = sp.length(sp.intersect(sp.merge(leaves), loop_busy))
    assert covered >= 0.98 * sp.length(loop_busy), (covered, sp.length(loop_busy), fits)
