"""The port's TensorBoard writer, the metrics mirror and the training
trace, on the CPU.

  * CRC-32C: the RFC 3720 check value and JAX's CRC on random bytes;
  * the port's `EventWriter` writes, with `time.time` pinned, the same
    bytes as JAX's (which encodes with tensorboard's protobufs), and
    tensorboard's `event_pb2` decodes them; the port's decoder reads them
    back;
  * `RunDir.metrics` mirrors every numeric scalar of `metrics.jsonl` to
    `<run>/tb/` under `<kind>/<key>`, byte for byte as JAX's RunDir does;
  * a CPU trainer with `profile_epoch` traces that epoch only (one
    Chrome trace, holding that epoch's optimizer steps), and its losses,
    weights and scalars equal those of an untraced run;
  * `trace` is a no-op when disabled, and `cli.train` passes
    `--profile_epoch` through instead of refusing it.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from nestinet_tpu.core import rundir as jax_rundir
from nestinet_tpu.core import tb as jax_tb
from nestinet_tpu_torch.core import rundir, tb
from nestinet_tpu_torch.core.profiling import trace
from nestinet_tpu_torch.train.trainer import Trainer

from .test_torch_trainer import data, tiny_cfg  # noqa: F401 (the fixture)

torch.set_num_threads(1)

WALL = 1761234567.890625


def test_crc32c_vectors():
    assert tb._crc32c(b"123456789") == 0xE3069283  # RFC 3720's check value
    assert tb._crc32c(b"") == 0
    rng = np.random.RandomState(0)
    for n in (1, 7, 8, 64, 1000):
        data = rng.bytes(n)
        assert tb._crc32c(data) == jax_tb._crc32c(data)
        assert tb._masked_crc(data) == jax_tb._masked_crc(data)


SCALARS = [  # (tag, value, step): zeros, signs, ints, float32 rounding and overflow
    ("train/loss", 0.5, 1), ("train/loss", 0.0, 0), ("eval/rms_deg", 7.123456789, 3),
    ("x", -2.5, -1), ("train/epoch", 12, 2**40), ("big", 1e40, 5), ("tiny", 1e-50, 6),
    ("neg_big", -1e39, 7), ("nan", float("nan"), 8), ("inf", float("inf"), 9),
    ("", 3.0, 10),
]


def _write(module, logdir):
    w = module.EventWriter(logdir)
    for tag, value, step in SCALARS:
        w.scalar(tag, value, step)
    w.scalars("eval", {"rms_deg": 7.5, "note": "skipped", "flag": True, "n": 3}, 11)
    w.scalars("", {"bare": 1.25}, 12)
    w.close()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name), "rb") as f:
        return name, f.read()


def test_event_records_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)
    got = _write(tb, str(tmp_path / "port"))
    want = _write(jax_tb, str(tmp_path / "jax"))
    assert got[0] == want[0] == f"events.out.tfevents.{int(WALL)}.{os.uname().nodename}"
    assert got[1] == want[1]


def test_event_records_decode(tmp_path, monkeypatch):
    from tensorboard.compat.proto.event_pb2 import Event

    monkeypatch.setattr(time, "time", lambda: WALL)
    name, _ = _write(tb, str(tmp_path))
    payloads = tb.read_events(str(tmp_path / name))
    events = []
    for payload in payloads:
        ev = Event()
        ev.ParseFromString(payload)
        events.append(ev)
    assert events[0].file_version == "brain.Event:2" and events[0].wall_time == WALL
    ours = [tb.decode_event(p) for p in payloads]
    assert ours[0] == {"wall_time": WALL, "step": 0, "file_version": "brain.Event:2"}
    with np.errstate(over="ignore"):  # float32 rounds 1e40 to inf, as protobuf does
        want = [(t, s, float(np.float32(v))) for t, v, s in SCALARS] + [
            ("eval/rms_deg", 11, 7.5), ("eval/n", 11, 3.0), ("bare", 12, 1.25)]
    pb = [(e.summary.value[0].tag, e.step, e.summary.value[0].simple_value) for e in events[1:]]
    for got in (pb, [(e["tag"], e["step"], e["simple_value"]) for e in ours[1:]],
                tb.read_scalars(str(tmp_path))):
        assert len(got) == len(want)
        for (t, s, v), (wt, ws, wv) in zip(got, want):
            assert (t, s) == (wt, ws) and (v == wv or (np.isnan(v) and np.isnan(wv)))


def test_read_events_refuses_a_corrupt_file(tmp_path):
    name, data = _write(tb, str(tmp_path))
    path = str(tmp_path / name)
    for cut in (data[:-1], data[:5], data[:30] + bytes([data[30] ^ 1]) + data[31:]):
        with open(path, "wb") as f:
            f.write(cut)
        with pytest.raises(ValueError):
            tb.read_events(path)


RECORDS = [
    dict(kind="train", epoch=0, step=4, loss=1.5, lr=1e-4, bn_decay=0.5, step_steps=4,
         step_mean_ms=12.25),
    dict(kind="eval", epoch=0, step=4, loss=1.25, rms_deg=31.5),
    dict(kind="train", epoch=1, step=8, loss=1.0, noise_loss=0.125, note="text"),
]


def _metrics_run(module, path):
    rd = module.RunDir(path)
    for rec in RECORDS:
        rd.metrics(**rec)
    rd.close()
    (name,) = os.listdir(os.path.join(path, "tb"))
    with open(os.path.join(path, "tb", name), "rb") as f:
        events = f.read()
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return events, f.read()


def test_rundir_metrics_mirror_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)
    got = _metrics_run(rundir, str(tmp_path / "port"))
    want = _metrics_run(jax_rundir, str(tmp_path / "jax"))
    assert got == want
    scalars = tb.read_scalars(str(tmp_path / "port" / "tb"))
    expect = [(f"{r['kind']}/{k}", r["step"], float(np.float32(v))) for r in RECORDS
              for k, v in r.items() if k not in ("kind", "step") and not isinstance(v, str)]
    assert scalars == expect


def _fit(data, path, profile_epoch):
    trainer = Trainer(tiny_cfg(data, path, profile_epoch=profile_epoch), loader_workers=2,
                      device="cpu")
    trainer.fit()
    with open(os.path.join(trainer.rundir.path, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    return trainer, metrics


def test_profile_epoch_traces_that_epoch_only(data, tmp_path):  # noqa: F811
    traced, m_traced = _fit(data, str(tmp_path / "traced"), 1)
    plain, m_plain = _fit(data, str(tmp_path / "plain"), -1)
    assert not os.path.exists(os.path.join(plain.rundir.path, "profile"))
    (name,) = os.listdir(os.path.join(traced.rundir.path, "profile"))
    assert name.startswith("trace.") and name.endswith(".json")
    with open(os.path.join(traced.rundir.path, "profile", name)) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name", "").startswith("Optimizer.step#")]
    per_epoch = [m["step"] for m in m_traced if m["kind"] == "train"]
    assert len(steps) == per_epoch[1] - per_epoch[0] == 4  # epoch 1's steps, no other's
    drop = ("time", "step_mean_ms", "step_p50_ms", "step_p90_ms", "step_p99_ms", "step_total_s")
    strip = lambda ms: [{k: v for k, v in m.items() if k not in drop} for m in ms]  # noqa: E731
    assert strip(m_traced) == strip(m_plain)
    a, b = traced.model.state_dict(), plain.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    tags = {t for t, _, _ in tb.read_scalars(os.path.join(traced.rundir.path, "tb"))}
    assert {"train/loss", "eval/rms_deg", "train/lr"} <= tags


def test_trace_disabled_is_a_noop(tmp_path):
    with trace(str(tmp_path / "off"), enabled=False, device="cpu"):
        torch.ones(3).sum()
    assert not os.path.exists(tmp_path / "off")
    with trace(str(tmp_path / "on"), device="cpu"):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    (name,) = os.listdir(tmp_path / "on")
    with open(tmp_path / "on" / name) as f:
        assert any(e.get("name") == "aten::mm" for e in json.load(f)["traceEvents"])


def test_cli_train_takes_profile_epoch():
    from nestinet_tpu_torch.cli.train import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args(["--profile_epoch", "2"]))
    assert cfg.profile_epoch == 2
