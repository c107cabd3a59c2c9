"""The benchmark's weights: each BatchNorm's moments are those of its own
input on the patches it is calibrated on, and a manager's logits then
differ between real patches by about 2 per expert."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import serve, weights
from portbench.reference import model as ref
from portbench.tests import toy
from portbench.traffic import generate


def _grid(spec, tmp_path, n=96):
    data = generate.write_list(str(tmp_path), "list", spec["traffic"], 2 ** 31 + 11)
    return serve.reference_grid(spec["config"], data, serve.calibration_picks(data, n),
                                spec["traffic"]["serve_seed"], spec["traffic"]["batch_size"],
                                torch.device("cpu"))


def test_the_first_batchnorm_takes_the_moments_of_its_input(tmp_path):
    spec = toy.spec("ms_serve_bf16")
    cfg = spec["config"]
    W = weights.make(cfg, 2 ** 33 + 5, torch.device("cpu"))
    grid = _grid(spec, tmp_path)
    assert weights.calibrate(cfg, W, grid) == {}
    p = "net.backbone.incep0.conv1"
    y = F.conv3d(grid.permute(0, 4, 1, 2, 3), W[f"{p}.conv.w"]) + W[f"{p}.conv.b"].view(
        1, -1, 1, 1, 1)
    keep = 1.0 - W[f"{p}.bn.bias"]
    torch.testing.assert_close(W[f"{p}.bn.ema_mean"] / keep, y.mean(dim=(0, 2, 3, 4)))
    torch.testing.assert_close(W[f"{p}.bn.ema_var"] / keep, y.var(dim=(0, 2, 3, 4),
                                                                  unbiased=False))


def test_the_managers_logits_differ_between_real_patches(tmp_path):
    spec = toy.spec("moe_serve_int8fold")
    cfg = spec["config"]
    W = weights.make(cfg, 2 ** 33 + 7, torch.device("cpu"))
    grid = _grid(spec, tmp_path)
    spread = weights.calibrate(cfg, W, grid)
    assert min(spread["z_std"]) > 0.05, spread
    with torch.no_grad():
        z = ref.manager(cfg, W)(grid.permute(0, 4, 1, 2, 3).contiguous())
    # the last ReLU cuts the negative logits, so the mean of 1 is not read
    assert float(z.std(dim=0).min()) > 1.0
    assert len(set(z.argmax(dim=1).tolist())) >= 3
