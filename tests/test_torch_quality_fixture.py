"""Two small run dirs trained by the JAX package, committed inside the port,
and the quality bar the port is held to on them.

`nestinet_tpu_torch/testdata/jax_run_moe_trained/` holds
  * `run/`: `config.json`, `gmm.json`, `metrics.jsonl` and `ckpt_best/` of
    an `experts_n_est` trained by JAX's `cli.train` on the CPU (`MOE_TRAIN`:
    a `tiny_backbone` at radii 0.01/0.03/0.05, 3^3 Gaussians, 128 points a
    patch, four experts keeping the flagship's two kinds, one-scale on each
    radius and three-scale; 20 epochs of 512 patches a shape on the 18
    training shapes, adam at 1e-3) on the protocol sets that `cli.synth`
    writes from `SYNTH`;
  * `anchor.json`: JAX's per-testset RMS, PGP5 and PGP10 of the six
    testsets in every mode of `MODES`, through JAX's
    `scripts/run_quality.py` (each shape's `.pidx` patches): host-dense
    float32 is the anchor; device-sparse float32, bfloat16, bfloat16 with
    BatchNorm folded, int8 and int8 folded beside it; and the clean
    testset's RMS of the same run before training (its seeded init).

`nestinet_tpu_torch/testdata/jax_run_switching/` holds
  * `run/`: the same files of an `ms_sw_n_est` trained by JAX's `cli.train`
    (`SWITCH_TRAIN`) on the `cli.synth --switching` sets of
    `SWITCH_SYNTH`, with `SW_BACKBONE` narrowed to the one-block `TINY` in
    both packages (the ablation models ignore `tiny_backbone`, and at full
    width the model is 670 MB); serve it with both packages'
    `models/backbones.py::SW_BACKBONE` set to `TINY` (its `README.md`);
  * `jax_switching_demo.txt`: what JAX's `scripts/switching_demo.py`
    prints on it: the per-noise-level table, the closing lines and the
    JSON line.

The data are not committed: both packages' `cli.synth` write identical
files.  The optimizer's moments are left out of each `ckpt_best/` (each of
their leaves is a 0-d zero): the fixtures are served, never resumed, and
the moments would take twice the weights' bytes.

The writer imports JAX, so it lives here and never in the port (about 20
minutes on the CPU, most of it JAX serving the six modes):

    JAX_PLATFORMS=cpu python -m tests.test_torch_quality_fixture --write

The tests hold the port on the CPU to the bars `chip_smoke.py` phase 18
holds it to on the card: per testset, host-dense float32 within
`F32_BAR_DEG` of the anchor's RMS, every other mode within `BAR_DEG` of
it and within `SAME_MODE_BAR_DEG` of JAX's same mode (here host-dense
float32; device-sparse float32, bfloat16 and bfloat16 folded in
`tests/test_torch_quality_device.py`, int8 and int8 folded in
`tests/test_torch_quality_int8.py`, so that the modes' CPU time spreads
over the test workers); the host-dense `.experts` identical to JAX's; the port's
`scripts/run_quality.py` against JAX's, run as a subprocess; the port's
`scripts/switching_demo.py` against JAX's committed table.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: E402,F401

torch.set_num_threads(2)  # a mode is about 100 s of plain MuPS on one thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(ROOT, "nestinet_tpu_torch", "testdata")
MOE = os.path.join(TESTDATA, "jax_run_moe_trained")
SWITCH = os.path.join(TESTDATA, "jax_run_switching")
SWITCH_TABLE = "jax_switching_demo.txt"
TESTDATA_NEW_BYTES = 12 * 2**20  # both fixtures together

SYNTH = ["--n_points", "10000", "--n_pidx", "1600", "--seed", "11"]
SWITCH_SYNTH = ["--switching", "--n_points", "5000", "--n_pidx", "200", "--seed", "23"]
EXPERTS = '{"0": "[0]", "1": "[1]", "2": "[2]", "3": "[0, 1, 2]"}'
COMMON_TRAIN = ["--num_point", "128", "--num_gaussians", "3", "--gmm_variance", str(1 / 9),
                "--batch_size", "64", "--learning_rate", "1e-3", "--seed", "11",
                "--loader_workers", "4", "--checkpoint_every", "100"]
MOE_TRAIN = COMMON_TRAIN + [
    "--model", "experts_n_est", "--patch_radius", "0.01", "0.03", "0.05",
    "--n_experts", "4", "--expert_dict", EXPERTS, "--patches_per_shape", "512",
    "--max_epoch", "20"]
SWITCH_TRAIN = COMMON_TRAIN + [
    "--model", "ms_sw_n_est", "--patch_radius", "0.01", "0.05",
    "--trainset", "trainingset_switching.txt", "--testset", "validationset_switching.txt",
    "--patches_per_shape", "128", "--max_epoch", "4"]
ANCHOR = "host-dense f32"
MODES = {  # run_quality's flags, both packages
    ANCHOR: ["--mode", "dense", "--dtype", "float32"],
    "device-sparse f32": ["--extraction", "device", "--mode", "sparse", "--dtype", "float32"],
    "device-sparse bf16": ["--extraction", "device", "--mode", "sparse", "--dtype", "bfloat16"],
    "device-sparse bf16+fold": ["--extraction", "device", "--mode", "sparse", "--dtype",
                                "bfloat16", "--fold_bn", "1"],
    "device-sparse int8": ["--extraction", "device", "--mode", "sparse", "--dtype", "int8"],
    "device-sparse int8+fold": ["--extraction", "device", "--mode", "sparse", "--dtype", "int8",
                                "--fold_bn", "1"],
}
F32_BAR_DEG = 0.01  # PERF.md §2: host-dense float32 against the anchor, per testset
BAR_DEG = 0.1  # the North star's bar: every other mode against the anchor
# each mode against JAX's same mode, per testset (PERF.md §2), 0.01 in every
# mode; the port's readings on the CPU: bfloat16 <= 0.0015, int8 0.0065, int8
# folded 0.0029.  The routed experts run on JAX's schedule
# (`infer/predict.py::SparseMoeRouter`), so under int8 each run quantizes the
# rows JAX's does; what is left is JAX's jitted rounding (XLA keeps float32
# inside fused bfloat16 chains), which moves a few manager ids and with them
# whole runs, where the port rounds as eager JAX does
# (`tests/test_torch_router.py`)
SAME_MODE_BAR_DEG = {
    ANCHOR: F32_BAR_DEG,
    "device-sparse f32": F32_BAR_DEG,
    "device-sparse bf16": 0.01,
    "device-sparse bf16+fold": 0.01,
    "device-sparse int8": 0.01,
    "device-sparse int8+fold": 0.01,
}
SERVE_BATCH = "256"
JAX_TIMEOUT = 600
SWITCH_SHARE_MIN = 0.1  # of the patches, down each branch
SWITCH_NOISE_ATOL = 1e-4
SWITCH_RMS_ATOL_DEG = 0.01


# ------------------------------------------------------------- the writer

@contextlib.contextmanager
def narrow_switching(*modules):
    """`SW_BACKBONE` of each given `models/backbones.py` set to its `TINY`."""
    saved = [m.SW_BACKBONE for m in modules]
    for m in modules:
        m.SW_BACKBONE = m.TINY
    try:
        yield
    finally:
        for m, s in zip(modules, saved):
            m.SW_BACKBONE = s


def jax_env(tmp: str) -> dict:
    """One CPU device (no virtual mesh), a compile cache of its own."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=os.path.join(tmp, "jax_cache"))
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def start_jax_quality(run: str, data: str, mode: str, tmp: str, name: str = "q"):
    """Start JAX's `scripts/run_quality.py` on a copy of `run` in `mode`, as
    a subprocess; returns the function that waits for it and returns
    {"json": its last line, "summary": {testset: {"rms", "pgp5",
    "pgp10"}}, "stdout", "results"}."""
    from nestinet_tpu_torch.scripts.run_quality import TESTSETS, read_summary

    copy = os.path.join(tmp, f"jax_{name}")
    shutil.copytree(run, copy)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "run_quality.py"), copy, "--data", data,
         "--batch", SERVE_BATCH, "--results_name", name, *MODES[mode]],
        env=jax_env(tmp), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def finish() -> dict:
        stdout, stderr = proc.communicate(timeout=JAX_TIMEOUT)
        if proc.returncode != 0:
            raise RuntimeError(f"JAX run_quality {mode} failed:\n{stderr[-3000:]}")
        results = os.path.join(copy, f"{name}_results")
        return {"json": json.loads(stdout.strip().splitlines()[-1]),
                "summary": {ts: read_summary(results, ts) for ts in TESTSETS},
                "stdout": stdout, "results": results}

    return finish


def run_jax_quality(run: str, data: str, mode: str, tmp: str, name: str = "q") -> dict:
    return start_jax_quality(run, data, mode, tmp, name)()


def jax_train(argv: list, log_dir: str, data: str) -> None:
    """JAX's `cli.train` with `tiny_backbone` set (it has no flag for it)."""
    from nestinet_tpu.cli import train as jax_cli_train

    config_from_args = jax_cli_train.config_from_args

    def tiny(args):
        cfg = config_from_args(args)
        cfg.tiny_backbone = True
        return cfg

    jax_cli_train.config_from_args = tiny
    try:
        jax_cli_train.main(argv + ["--log_dir", log_dir, "--data_path", data])
    finally:
        jax_cli_train.config_from_args = config_from_args


def copy_served(run: str, out: str, data_path: str) -> None:
    """`run`'s config (its paths made relative), GMM, metrics and best
    checkpoint into `out`, the optimizer's moments left out."""
    import dataclasses

    import jax
    from flax import serialization

    from nestinet_tpu.core import checkpoint as jax_ckpt
    from nestinet_tpu.core.config import Config

    os.makedirs(out)
    cfg = Config.load(os.path.join(run, "config.json"))
    dataclasses.replace(cfg, log_dir="run", data_path=data_path).save(
        os.path.join(out, "config.json"))
    for name in ("gmm.json", "metrics.jsonl"):
        shutil.copy(os.path.join(run, name), os.path.join(out, name))
    best = os.path.join(run, "ckpt_best")
    with open(os.path.join(best, jax_ckpt.META_NAME)) as f:
        meta = json.load(f)
    with open(os.path.join(best, meta["file"]), "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    jax_ckpt.save(os.path.join(out, "ckpt_best"), params=tree["params"], state=tree["state"],
                  opt_state=jax.tree.map(lambda a: np.zeros((), np.asarray(a).dtype),
                                         tree["opt_state"]),
                  step=meta["step"], epoch=meta["epoch"])


def untrained_run(out: str, data: str) -> str:
    """The MoE run as `cli.train` starts it (its seeded init), as a run dir."""
    from nestinet_tpu.cli import train as jax_cli_train
    from nestinet_tpu.core import checkpoint as jax_ckpt
    from nestinet_tpu.core.rundir import RunDir
    from nestinet_tpu.train.trainer import Trainer

    args = jax_cli_train.build_parser().parse_args(
        MOE_TRAIN + ["--log_dir", out, "--data_path", data])
    cfg = jax_cli_train.config_from_args(args)
    cfg.tiny_backbone = True
    trainer = Trainer(cfg, run_dir=RunDir.create(out), loader_workers=4)
    train_loader, _, _ = trainer.make_loaders()
    trainer.initialize(next(iter(train_loader)), resume=False)
    jax_ckpt.save(trainer.rundir.ckpt_dir, params=trainer.params, state=trainer.state,
                  opt_state=trainer.opt_state, step=0, epoch=0)
    trainer.rundir.close()
    return trainer.rundir.path


def jax_switching_demo(run: str, data: str, testset: str, tmp: str) -> str:
    """What JAX's `scripts/switching_demo.py` prints on a copy of `run`
    named `run` (the caller narrows `SW_BACKBONE`)."""
    import io
    import runpy

    where = tempfile.mkdtemp(dir=tmp)
    shutil.copytree(run, os.path.join(where, "run"))
    out, argv, cwd = io.StringIO(), sys.argv, os.getcwd()
    sys.argv = ["switching_demo.py", "run", "--data", data, "--testset", testset]
    os.chdir(where)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(ROOT, "scripts", "switching_demo.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
        os.chdir(cwd)
    return out.getvalue()


def write_moe(tmp: str) -> None:
    from nestinet_tpu.cli import synth as jax_synth

    data = os.path.join(tmp, "data")
    jax_synth.main(["--root", data, *SYNTH])
    jax_train(MOE_TRAIN, os.path.join(tmp, "train"), data)
    if os.path.exists(MOE):
        shutil.rmtree(MOE)
    run = os.path.join(MOE, "run")
    copy_served(os.path.join(tmp, "train"), run, "data/synth_pcpnet")
    anchor = {"synth": SYNTH, "train": MOE_TRAIN, "anchor": ANCHOR, "mode_flags": MODES,
              "modes": {}}
    for i, mode in enumerate(MODES):
        anchor["modes"][mode] = run_jax_quality(run, data, mode, tmp, f"m{i}")["summary"]
        print(f"{mode}: {json.dumps(anchor['modes'][mode])}", flush=True)
    untrained = untrained_run(os.path.join(tmp, "untrained"), data)
    anchor["untrained_testset_rms"] = run_jax_quality(
        untrained, data, ANCHOR, tmp, "untrained")["summary"]["testset"]["rms"]
    with open(os.path.join(MOE, "anchor.json"), "w") as f:
        json.dump(anchor, f, indent=1)
        f.write("\n")


def write_switching(tmp: str) -> None:
    from nestinet_tpu.cli import synth as jax_synth
    from nestinet_tpu.models import backbones as jax_backbones

    data = os.path.join(tmp, "sdata")
    jax_synth.main(["--root", data, *SWITCH_SYNTH])
    with narrow_switching(jax_backbones):
        jax_train(SWITCH_TRAIN, os.path.join(tmp, "strain"), data)
        if os.path.exists(SWITCH):
            shutil.rmtree(SWITCH)
        run = os.path.join(SWITCH, "run")
        copy_served(os.path.join(tmp, "strain"), run, "data/synth_switching")
        val = jax_switching_demo(run, data, "validationset_switching.txt", tmp)
        print(f"switching, validation set: {val.strip().splitlines()[-1]}", flush=True)
        table = jax_switching_demo(run, data, "testset_switching.txt", tmp)
    with open(os.path.join(SWITCH, SWITCH_TABLE), "w") as f:
        f.write(table)


def write_fixtures() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        write_moe(tmp)
        write_switching(tmp)


# -------------------------------------------------------------- the tests

def _anchor() -> dict:
    with open(os.path.join(MOE, "anchor.json")) as f:
        return json.load(f)


def _port_quality(argv: list) -> tuple:
    """The port's `scripts/run_quality.py` in this process: (its return,
    what it printed)."""
    import io

    from nestinet_tpu_torch.scripts import run_quality

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = run_quality.main(argv)
    return got, out.getvalue()


@contextlib.contextmanager
def statistics_reused():
    """The plain MuPS statistics of a batch computed once for all the modes
    that serve the same points: the device-sparse modes extract the same
    patches and compute the grid in float32 in every dtype, and the plain
    version is three quarters of a mode's CPU time.  A cache keyed by the
    inputs' bytes around `ops/mups.py::tdmfv_n_est_reference` returns what
    computing them again would."""
    import hashlib

    from nestinet_tpu_torch.ops import mups

    plain, cache = mups.tdmfv_n_est_reference, {}

    def reused(*args):
        key = hashlib.blake2b(b"".join(t.detach().contiguous().numpy().tobytes()
                                       for t in args), digest_size=16).digest()
        if key not in cache:
            cache[key] = plain(*args)
        return cache[key].clone()

    mups.tdmfv_n_est_reference = reused
    try:
        yield
    finally:
        mups.tdmfv_n_est_reference = plain


def serve_modes(tmp_path_factory, modes, with_jax: bool = False) -> dict:
    """The committed MoE run dir served on the CPU by the port's
    `run_quality` in each of `modes`, on the protocol sets of the port's
    `cli.synth`; `with_jax`: JAX's `scripts/run_quality.py` in host-dense
    float32 beside them (a subprocess, started first).  {"port": {mode:
    (return, printed)}, "jax": JAX's run or None, "data"}."""
    from nestinet_tpu_torch.cli import synth

    tmp = str(tmp_path_factory.mktemp("quality"))
    data = os.path.join(tmp, "data")
    synth.main(["--root", data, *SYNTH])
    jax = start_jax_quality(os.path.join(MOE, "run"), data, ANCHOR, tmp) if with_jax else None
    run = os.path.join(tmp, "port")
    shutil.copytree(os.path.join(MOE, "run"), run)
    with statistics_reused():
        port = {mode: _port_quality([run, "--data", data, "--batch", SERVE_BATCH,
                                     "--results_name", f"p{i}", "--device", "cpu",
                                     *MODES[mode]])
                for i, mode in enumerate(modes)}
    return {"jax": jax and jax(), "port": port, "data": data}


def check_anchor_bar(served: dict, mode: str) -> None:
    """The port on the CPU, per testset: host-dense float32 within
    `F32_BAR_DEG` of JAX's host-dense float32 RMS (the anchor), every other
    mode within `BAR_DEG` of it; every mode also within
    `SAME_MODE_BAR_DEG[mode]` of JAX's same mode (JAX's own device
    extraction departs from its host extraction by a few hundredths of a
    degree here: they sample different points of the patches that hold
    more than 128)."""
    modes = _anchor()["modes"]
    got = served["port"][mode][0]["summary"]
    refs = {ANCHOR: F32_BAR_DEG if mode == ANCHOR else BAR_DEG}
    if mode != ANCHOR:
        refs[mode] = SAME_MODE_BAR_DEG[mode]
    for ref, bar in refs.items():
        gaps = {ts: abs(got[ts]["rms"] - modes[ref][ts]["rms"]) for ts in modes[ref]}
        print(f"{mode}: RMS gaps to JAX's {ref} {gaps}")
        assert max(gaps.values()) <= bar, (ref, gaps)


@pytest.fixture(scope="module")
def quality(tmp_path_factory):
    return serve_modes(tmp_path_factory, (ANCHOR,), with_jax=True)


def test_jax_reserves_the_anchor(quality):
    """JAX's `run_quality` on the committed run dir today gives the RMS that
    `anchor.json` recorded, within 1e-6 per testset (XLA's CPU code may sum
    in another order on another CPU)."""
    want = _anchor()["modes"][ANCHOR]
    got = quality["jax"]["summary"]
    assert got.keys() == want.keys()
    for ts in want:
        np.testing.assert_allclose(got[ts]["rms"], want[ts]["rms"], atol=1e-6, rtol=0,
                                   err_msg=ts)


def test_port_meets_the_anchor_bar(quality):
    """`check_anchor_bar` in host-dense float32 (the other modes:
    `tests/test_torch_quality_{device,int8}.py`)."""
    check_anchor_bar(quality, ANCHOR)


def test_port_experts_equal_jax_in_host_dense_f32(quality):
    """Host-dense float32: every shape's `.experts` identical to JAX's."""
    from nestinet_tpu_torch.scripts.run_quality import TESTSETS

    port_dir = quality["port"][ANCHOR][0]["stats"][TESTSETS[0]]["output_dir"]
    jax_dir = quality["jax"]["results"]
    names = [n for ts in TESTSETS for n in open(os.path.join(quality["data"], ts + ".txt"))
             .read().split()]
    assert len(names) == 36
    for name in names:
        np.testing.assert_array_equal(np.loadtxt(os.path.join(port_dir, name + ".experts")),
                                      np.loadtxt(os.path.join(jax_dir, name + ".experts")),
                                      err_msg=name)


def test_port_run_quality_prints_jax_table(quality):
    """The port's table and JSON line against JAX's script's on the same run
    dir and data in host-dense float32: the same lines, keys and testsets,
    RMS within `F32_BAR_DEG`, PGP5 / PGP10 within 1e-3."""
    got_json, got_out = quality["port"][ANCHOR][0]["json"], quality["port"][ANCHOR][1]
    want_json, want_out = quality["jax"]["json"], quality["jax"]["stdout"]
    assert got_json.keys() == want_json.keys()
    assert {k: got_json[k] for k in ("extraction", "dtype", "mode")} == \
        {k: want_json[k] for k in ("extraction", "dtype", "mode")}
    assert got_json["rms"].keys() == want_json["rms"].keys()
    for ts, rms in want_json["rms"].items():
        assert abs(got_json["rms"][ts] - rms) <= F32_BAR_DEG, ts
    assert abs(got_json["avg_rms"] - want_json["avg_rms"]) <= F32_BAR_DEG

    def table(text):
        return [line.split("|")[1:-2] for line in text.splitlines() if line.startswith("|")]

    got, want = table(got_out), table(want_out)
    assert got[:2] == want[:2] and len(got) == len(want) == 8
    for g, w in zip(got[2:], want[2:]):
        assert g[0] == w[0]
        for col, atol in zip(range(1, 4), (F32_BAR_DEG, 1e-3, 1e-3)):
            assert abs(float(g[col]) - float(w[col])) <= atol, (w[0], col)
    assert [line for line in got_out.splitlines() if line.startswith("average RMS")]


def test_training_halves_the_untrained_rms():
    """The trained run's clean-testset RMS is at most half the untrained
    run's (its seeded init), both from `anchor.json`."""
    anchor = _anchor()
    trained = anchor["modes"][ANCHOR]["testset"]["rms"]
    assert trained <= 0.5 * anchor["untrained_testset_rms"], (trained, anchor)


def test_committed_fixtures_stay_small():
    total = sum(os.path.getsize(os.path.join(d, n)) for root in (MOE, SWITCH)
                for d, _, names in os.walk(root) for n in names)
    assert total < TESTDATA_NEW_BYTES, total
    assert sorted(os.listdir(os.path.join(MOE, "run"))) == sorted(os.listdir(
        os.path.join(SWITCH, "run"))) == ["ckpt_best", "config.json", "gmm.json",
                                          "metrics.jsonl"]


def test_chip_smoke_serves_the_fixtures_as_written():
    """Phase 18 of `chip_smoke.py` reads the MoE's data and modes from
    `anchor.json`; its switching data and bars are these."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name) and t.id in (
                  "SWITCH_SYNTH", "QUALITY_F32_BAR_DEG", "QUALITY_BAR_DEG",
                  "QUALITY_SAME_MODE_BAR_DEG", "SWITCH_NOISE_ATOL", "SWITCH_RMS_ATOL_DEG",
                  "QUALITY_BATCH")}
    assert consts == {"SWITCH_SYNTH": SWITCH_SYNTH, "QUALITY_F32_BAR_DEG": F32_BAR_DEG,
                      "QUALITY_BAR_DEG": BAR_DEG,
                      "QUALITY_SAME_MODE_BAR_DEG": SAME_MODE_BAR_DEG,
                      "SWITCH_NOISE_ATOL": SWITCH_NOISE_ATOL,
                      "SWITCH_RMS_ATOL_DEG": SWITCH_RMS_ATOL_DEG,
                      "QUALITY_BATCH": int(SERVE_BATCH)}
    anchor = _anchor()
    assert anchor["synth"] == SYNTH and anchor["mode_flags"] == MODES
    assert list(anchor["modes"]) == list(MODES) and anchor["anchor"] == ANCHOR


def _jax_switching_table() -> dict:
    with open(os.path.join(SWITCH, SWITCH_TABLE)) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def test_switching_fixture_pins_both_branches():
    """At least `SWITCH_SHARE_MIN` of the served patches down each branch."""
    share = _jax_switching_table()["small_branch_share"]
    assert SWITCH_SHARE_MIN <= share <= 1 - SWITCH_SHARE_MIN, share


def test_switching_fixture_needs_the_narrowing(tmp_path):
    """Served without `SW_BACKBONE` narrowed, as its README says it must
    not be, the switching run dir is refused with a ValueError that names
    `SW_BACKBONE` (`infer/predict.py::check_widths`)."""
    from nestinet_tpu_torch.infer.predict import load_run

    run = str(tmp_path / "run")
    shutil.copytree(os.path.join(SWITCH, "run"), run)
    with pytest.raises(ValueError, match="SW_BACKBONE"):
        load_run(run, torch.device("cpu"))
    assert "SW_BACKBONE" in open(os.path.join(SWITCH, "README.md")).read()


def test_port_switching_demo_matches_jax(tmp_path, capsys):
    """The port's `switching_demo` on the CPU against JAX's committed table:
    per noise level the small-branch share within one patch, the mean noise
    within `SWITCH_NOISE_ATOL`, the RMS within `SWITCH_RMS_ATOL_DEG`; the
    same lines and keys."""
    from nestinet_tpu_torch.cli import synth
    from nestinet_tpu_torch.models import backbones
    from nestinet_tpu_torch.scripts import switching_demo

    data, run = str(tmp_path / "data"), str(tmp_path / "run")
    synth.main(["--root", data, *SWITCH_SYNTH])
    shutil.copytree(os.path.join(SWITCH, "run"), run)  # RunDir.open adds ckpt/
    with narrow_switching(backbones):
        got = switching_demo.main([run, "--data", data, "--device", "cpu"])
    printed = capsys.readouterr().out
    want = _jax_switching_table()
    assert json.loads(printed.strip().splitlines()[-1]).keys() == want.keys()
    assert got["n_patches"] == want["n_patches"]
    assert got["per_sigma"].keys() == want["per_sigma"].keys()
    for sigma, w in want["per_sigma"].items():
        g, n = got["per_sigma"][sigma], got["patches_per_sigma"][sigma]
        assert abs(g["small_branch_frac"] - w["small_branch_frac"]) * n <= 1 + 1e-9, sigma
        assert abs(g["mean_noise_pred"] - w["mean_noise_pred"]) <= SWITCH_NOISE_ATOL, sigma
        assert abs(g["rms_deg"] - w["rms_deg"]) <= SWITCH_RMS_ATOL_DEG, sigma
    assert abs(got["rms_deg"] - want["rms_deg"]) <= SWITCH_RMS_ATOL_DEG
    assert abs(got["small_branch_share"] - want["small_branch_share"]) * got["n_patches"] \
        <= len(want["per_sigma"])
    with open(os.path.join(SWITCH, SWITCH_TABLE)) as f:
        jax_lines = f.read().splitlines()

    def heads(lines):
        start = next(i for i, line in enumerate(lines) if line.startswith("| GT sigma"))
        return [line.split(":")[0] if ":" in line else line.split("|")[1]
                for line in lines[start:-1] if line]

    assert heads(printed.splitlines()) == heads(jax_lines)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Write the committed trained run dirs.")
    parser.add_argument("--write", action="store_true", help=f"rewrite {MOE} and {SWITCH}")
    if not parser.parse_args().write:
        parser.print_help()
        sys.exit(2)
    write_fixtures()
    print(f"wrote {MOE} and {SWITCH}")
