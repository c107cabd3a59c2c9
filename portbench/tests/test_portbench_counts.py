"""The counts of `portbench/counts/` against torch's FlopCounterMode on
the reference at full width (meta tensors: shapes only), the parameter
counts of the configuration files, and the reference's tensor layout
against the program's state dict."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.counts import flops
from portbench.reference import model as ref

CONFIGS = ["experts_n_est", "ms_norm_est"]
# GFLOP a patch, to two decimals: the manager, a
# one-scale expert, the all-scale expert; the MS network
EXPECTED = {"experts_n_est": {"manager": 14.86, "expert0": 7.10, "expert6": 5.83},
            "ms_norm_est": {"net": 15.48}}


def config(name):
    return harness.load_json(f"{harness.HERE}/configs/{name}.json")


def meta_weights(cfg):
    return {k: torch.empty(shape, device="meta") for k, shape, _ in ref.param_specs(cfg)}


def counted(cfg, part):
    W = meta_weights(cfg)
    S, res = len(cfg["patch_radius"]), cfg["num_gaussians"]
    if part == "manager":
        net, cin = ref.manager(cfg, W), 20 * S
    elif part == "net":
        net, cin = ref.ms_net(cfg, W), 20 * S
    else:
        i = int(part[len("expert"):])
        net, cin = ref.expert(cfg, W, i), 20 * len(ref.expert_scales(cfg)[i])
    x = torch.empty((2, cin, res, res, res), device="meta")
    with FlopCounterMode(display=False) as fc:
        net(x)
    return fc.get_total_flops() / 2 / 1e9


@pytest.mark.parametrize("name", CONFIGS)
def test_gflop_per_patch_equals_flop_counter(name):
    cfg = config(name)
    ours = flops.gflop_per_patch(cfg)
    for part, value in ours.items():
        assert counted(cfg, part) == pytest.approx(value, rel=1e-12)
    for part, want in EXPECTED[name].items():
        assert round(ours[part], 2) == want


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_count_is_the_config_files(name):
    cfg = config(name)
    assert ref.n_parameters(cfg) == cfg["parameters"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_layout_is_the_programs_state_dict(name):
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    from portbench.serve import program_config

    cfg = config(name)
    with torch.device("meta"):
        model = build_model(program_config(cfg, "unused"),
                            get_3d_grid_gmm([cfg["num_gaussians"]] * 3, cfg["gmm_variance"]),
                            torch.Generator())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(shape) for k, shape, _ in ref.param_specs(cfg)}
    assert got == want


def test_int8_bound_of_the_widest_conv():
    # B 256, 256 -> 128, k 5 on 8^3: 1.07e12 operations at 1,979 TOPS
    t = flops.int8_bound_s(256, 256, 128, 5, 8)
    assert t == pytest.approx(2 * 256 * 512 * 128 * 256 * 125 / 1979e12)
    assert math.isclose(t * 1e3, 0.5426, rel_tol=1e-3)
