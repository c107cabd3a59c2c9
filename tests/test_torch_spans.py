"""The serving job's spans and counters (`core/profiling.py`), on the CPU.

A tiny-backbone `experts_n_est` run dir, made as
`tests/test_torch_slice.py::build_run` makes it (the same config, the
synthetic protocol testset of 6 shapes x 300 points, 100 `.pidx` queries
each) but with the port alone (weights from the config's seed), so that
no JAX model is built, serves the `.pidx` subsets through
`predict_shapes_device(device="cpu")`.  Outside a profiler the job records
nothing; under `torch.profiler.profile` its stats carry the span tree and
the counters, and the profiler's own events carry the span names.
"""

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nestinet_tpu_torch.core import checkpoint, profiling
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.core.rundir import RunDir
from nestinet_tpu_torch.data.synthetic import TEST_SHAPES, build_protocol_benchmark
from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
from nestinet_tpu_torch.models import build_model
from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

BATCH = 64  # 100 queries a shape: two batches each, the second padded
# the stats of a routed job, key for key
ROUTED_KEYS = {"compute_dtype", "data_parallel", "device", "expert_rows", "expert_runs",
               "fold_bn", "forced_flushes", "model", "moe_inference", "n_batches", "n_patches",
               "output_dir", "patches_per_sec", "per_rank", "seconds", "shapes", "window_caps",
               "window_slots"}
# load_run's parts in order: the checkpoint copied to the device once, after
# the read; int8 + fold then folds and quantizes there
LOAD_RUN = ["load_run.build", "load_run.read", "load_run.upload", "load_run.load_state"]
PREPARE = ["load_run.fold", "load_run.quantize"]
# the jobs served under the profiler: routed, dense, and routed in int8 + fold
MODES = {"sparse": dict(moe_inference="sparse"), "dense": dict(moe_inference="dense"),
         "int8fold": dict(moe_inference="sparse", compute_dtype="int8", fold_bn=True)}
LOOP = {"shape", "batch.extract", "batch.mups", "batch.model", "router.commit",
        "router.finish", "outputs.finish"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_spans"))
    data = os.path.join(root, "data")
    build_protocol_benchmark(data, n_points=300, n_pidx=100, seed=5)
    cfg = Config(model="experts_n_est", tiny_backbone=True, log_dir=os.path.join(root, "run"),
                 data_path=data, num_gaussians=3, gmm_variance=1.0 / 9, num_point=16,
                 patch_radius=(0.05, 0.1, 0.2))
    rd = RunDir.create(cfg.log_dir)
    cfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    gmm.save(rd.gmm_path)
    checkpoint.save(rd.path, build_model(cfg, gmm).state_dict())
    return root, data, rd.path


def serve(run, name, **kw):
    root, data, run_path = run
    return predict_shapes_device(run_path, testset="testset.txt", data_path=data,
                                 batch_size=BATCH, sparse_patches=True, device="cpu",
                                 output_dir=os.path.join(root, name), **kw)


@pytest.fixture(scope="module")
def profiled(run):
    """{mode: (stats, the profiler's event names, the names of the fetch and
    upload calls)} of each job of `MODES` served under the profiler."""
    out = {}
    for mode, kw in MODES.items():
        calls = []
        inner = profiling.fetch, profiling.upload

        def fetch(name, *args):
            calls.append(name)
            return inner[0](name, *args)

        def upload(name, *args):
            calls.append(name)
            return inner[1](name, *args)

        profiling.fetch, profiling.upload = fetch, upload
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                stats = serve(run, "on_" + mode, **kw)
        finally:
            profiling.fetch, profiling.upload = inner
        # the profiler's raw results: its `events()` take seconds to build
        out[mode] = (stats, {e.name() for e in prof.profiler.kineto_results.events()}, calls)
    return out


def serve_unrecorded(run, monkeypatch, mode):
    """The stats of a job served outside a profiler, which fails if the
    recorder makes a span, a CUDA event, a marker or a synchronize."""
    def refuse(*args, **kwargs):
        raise AssertionError("the recorder ran outside a profiler")

    monkeypatch.setattr(profiling, "JobTrace", refuse)
    monkeypatch.setattr(profiling, "_Span", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "_sleep", refuse)
    stats = serve(run, "off_" + mode, moe_inference=mode)
    assert profiling._JOB.get() is None
    return stats


def test_a_job_outside_a_profiler_records_nothing(run, monkeypatch):
    assert set(serve_unrecorded(run, monkeypatch, "sparse")) == ROUTED_KEYS


def test_a_dense_job_outside_a_profiler_records_nothing(run, profiled, monkeypatch):
    """Key for key the stats of the same job under the profiler, less its
    `trace`."""
    stats = serve_unrecorded(run, monkeypatch, "dense")
    assert set(stats) == set(profiled["dense"][0]) - {"trace"}


@pytest.mark.parametrize("mode", MODES)
def test_a_profiled_job_returns_its_span_tree(profiled, mode):
    stats, profiler_names, _ = profiled[mode]
    spans = stats["trace"]["spans"]
    by_id = {s["id"]: s for s in spans}
    assert len({s["job"] for s in spans}) == 1
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "job"
    for s in spans:
        assert s["start"] <= s["end"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["id"] < s["id"] and p["start"] <= s["start"] and s["end"] <= p["end"]
        assert "device_start" not in s  # no device intervals on the CPU
    assert "anchors" not in stats["trace"]

    def children(name):
        (s,) = [s for s in spans if s["name"] == name]
        return [c["name"] for c in spans if c["parent"] == s["id"]]

    assert children("job") == ["load_run", "clouds", "caps", "loop"]
    assert children("load_run") == LOAD_RUN + (PREPARE if mode == "int8fold" else [])
    loop_children = children("loop")
    routed = mode != "dense"
    # dense, the outputs are fetched and written between the batches' spans
    assert set(loop_children) == (LOOP if routed else LOOP - {"router.commit", "router.finish"}
                                  | {"fetch.outputs", "write"})
    n = stats["n_batches"]
    for name in ("batch.extract", "batch.mups", "batch.model"):
        assert loop_children.count(name) == n
    assert loop_children.count("shape") == len(TEST_SHAPES)
    names = [s["name"] for s in spans]
    assert names.count("write.flush") == len(TEST_SHAPES)
    if routed:
        assert names.count("router.expert") == names.count("fetch.normals") == stats["expert_runs"]
        assert names.count("fetch.probs") == n
    else:
        assert names.count("fetch.outputs") == 3 * n  # normals, ids and probabilities
    (loop,) = [s for s in spans if s["name"] == "loop"]
    assert loop["end"] - loop["start"] == pytest.approx(stats["seconds"], abs=1e-3)
    # each span is a record_function range of its name in the profiler's trace
    assert set(names) <= profiler_names


@pytest.mark.parametrize("mode", MODES)
def test_host_syncs_count_every_fetch_and_upload(profiled, mode):
    stats, _, calls = profiled[mode]
    spans = [s["name"] for s in stats["trace"]["spans"]]
    waits = [n for n in spans if n.startswith(("fetch.", "upload."))]
    assert stats["trace"]["counters"]["host_syncs"] == len(calls) == len(waits)
    assert sorted(calls) == sorted(waits)
    # per batch: the queries, and each radius's extraction (its radius twice,
    # the draw's seed where a ball outgrows the patch); per shape: the cloud
    # and each radius's grid
    n, shapes = stats["n_batches"], len(TEST_SHAPES)
    assert waits.count("upload.queries") == n and waits.count("upload.cloud") == shapes
    assert waits.count("upload.radius") == 3 * shapes + 6 * n

