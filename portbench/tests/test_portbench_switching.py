"""The noise-switching model's cell on the CPU: its counts against torch's
FlopCounterMode and the configuration file, the reference's tensor layout
against the program's state dict, the configuration's backbone against
the program's, the noise head's spread across the switch, and a rehearsal
of the cell's check at toy sizes (`toy.py`) in which a sound run is
correct and each fault of `faults_switching.py`, and the reference at 4
bits in the program's place, is not."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import faults_switching, harness, serve, serve_switching, weights_switching
from portbench.counts import switching as counts
from portbench.reference import switching as ref
from portbench.tests import toy
from portbench.traffic import generate

CELL = "sw_serve_int8fold"


def config():
    return harness.load_json(f"{harness.HERE}/configs/ms_sw_n_est.json")


def test_gflop_and_parameters_equal_flop_counter_and_the_config_file():
    cfg = config()
    W = {k: torch.empty(shape, device="meta") for k, shape, _ in ref.param_specs(cfg)}
    ours = counts.gflop_per_patch(cfg)
    for name, net in ref.nets(cfg, W).items():
        x = torch.empty((2, 20, 8, 8, 8), device="meta")
        with FlopCounterMode(display=False) as fc:
            net(x)
        assert fc.get_total_flops() / 2 / 1e9 == pytest.approx(ours[name], rel=1e-12)
    assert {k: round(v, 2) for k, v in ours.items()} == cfg["gflop_per_patch"]
    assert ref.n_parameters(cfg) == cfg["parameters"] == 200712327
    # a routed patch: the noise CNN and one branch
    assert counts.served_gflop(cfg, 2, {"small_scale": 1, "large_scale": 1}) == pytest.approx(
        2 * ours["noise"] + ours["small"] + ours["large"])


def test_reference_layout_is_the_programs_state_dict():
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    cfg = config()
    with torch.device("meta"):
        model = build_model(serve.program_config(cfg, "unused"),
                            get_3d_grid_gmm([cfg["num_gaussians"]] * 3, cfg["gmm_variance"]),
                            torch.Generator())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(shape) for k, shape, _ in ref.param_specs(cfg)} == want
    assert list(want) == [k for k, _, _ in ref.param_specs(cfg)]


def test_the_configs_backbone_is_the_programs_and_a_drifted_one_raises_on_a_card():
    from nestinet_tpu_torch.models import backbones

    program = backbones.SW_BACKBONE
    with serve_switching.program_backbone(config(), torch.device("meta")):
        assert backbones.SW_BACKBONE is program
    narrowed = toy.spec(CELL)["config"]
    with pytest.raises(ValueError, match="SW_BACKBONE"):
        with serve_switching.program_backbone(narrowed, torch.device("meta")):
            pass
    with serve_switching.program_backbone(narrowed, torch.device("cpu")):
        assert len(backbones.SW_BACKBONE) == len(narrowed["net"]["backbone"])
    assert backbones.SW_BACKBONE is program


def test_the_noise_head_is_spread_across_the_switch(tmp_path):
    spec = toy.spec(CELL)
    cfg, traffic = spec["config"], spec["traffic"]
    data = generate.write_list(str(tmp_path), "list", traffic, 2 ** 31 + 11)
    grid = serve.reference_grid(cfg, data, serve.calibration_picks(data, 96),
                                traffic["serve_seed"], traffic["batch_size"],
                                torch.device("cpu"))
    W = weights_switching.make(cfg, 2 ** 33 + 5, torch.device("cpu"))
    spread = weights_switching.calibrate(cfg, W, grid)
    assert spread["small_share"] == 0.5
    noise = ref.serve_grid(cfg, W, grid)["noise"].numpy()
    t = cfg["noise_threshold"]
    n = noise.size  # the toy list's 80 queries
    middle = np.sort(noise)[n // 2 - 1:n // 2 + 1]  # the two middle patches lie on either side
    assert middle[0] < t <= middle[1] and middle[1] - middle[0] < 1e-3
    assert 0.005 < float(np.std(noise)) < 0.012  # 0.01 N(0, 1), the ReLU cuts the lowest
    # the three CNNs draw their own weights
    assert not torch.equal(W["noise.backbone.incep0.conv1.conv.w"],
                           W["large.backbone.incep0.conv1.conv.w"])


def run(spec, tmp_path, control=False, seed=2 ** 31 + 77):
    return harness.run_cell(CELL, seed, 0.2, False, torch.device("cpu"), time.perf_counter(),
                            str(tmp_path), spec=spec, control=control)


@pytest.fixture
def spec():
    s = toy.spec(CELL)
    s["cell"]["serve"].update(compute_dtype="float32", fold_bn=False)
    return s


def test_a_sound_run_is_correct(spec, tmp_path):
    line = run(spec, tmp_path)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] == 80
    assert set(line["checks"]) == {"normal_gap", "normal_gap_p50", "branch_miss",
                                   "noise_gap_p50", "switch_mismatch", "rows_bad"}


@pytest.mark.parametrize("fault", faults_switching.FAULTS)
def test_a_planted_fault_is_not_correct(spec, tmp_path, fault):
    with faults_switching.planted(fault):
        line = run(spec, tmp_path)
    assert not line["correct"], line["checks"]
    assert line["checks"]["switch_mismatch"][0] == 0  # each file row agrees with itself


def test_the_control_is_not_correct(spec, tmp_path):
    line = run(spec, tmp_path, control=True)
    assert not line["correct"], line["checks"]
