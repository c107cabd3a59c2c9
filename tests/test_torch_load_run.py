"""`infer/predict.py::load_run`: the served weights made once, on the
serving device, from the checkpoint alone.

The model is built there without drawing weights, the checkpoint read and
copied to the device once, and the BatchNorm fold and the int8 quantize
run on those tensors in torch ops.  The reference is the NumPy host path
the port served with before (copied below, `_numpy_fold` and
`_numpy_quantize`, as JAX's `fold_bn_params_np` and `quantize_params_np`
compute them): every int8 kernel, float32 scale, folded float32 kernel and
bias, and float32 master must be `torch.equal` to it.  On the CPU a
tiny-backbone mixture of experts, in the four serving modes; on the card
(the `card` test, skipped without one) the full-width flagship, 178 M
parameters.  Also: a checkpoint that lacks a parameter raises, `load_run`
draws no weights, and `build_model` alone still draws the seeded weights
training starts from.

This file imports no JAX.  The card test runs without the suite's
conftest, which imports it:

    python -m pytest tests/test_torch_load_run.py --noconftest -p no:cacheprovider -m card
"""

import hashlib

import numpy as np
import pytest
import torch

from nestinet_tpu_torch.core import checkpoint
from nestinet_tpu_torch.core.config import Config
from nestinet_tpu_torch.core.rundir import RunDir
from nestinet_tpu_torch.infer.predict import load_run
from nestinet_tpu_torch.models import build_model, init_params
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
from nestinet_tpu_torch.ops.quant import padded_channels
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

# (compute dtype, fold) of the four serving modes
MODES = [("int8", True), ("int8", False), ("bfloat16", True), ("bfloat16", False)]
# sha256 of the tiny flagship's state dict as `build_model(tiny_cfg())` drew
# it before `load_run` stopped initialising (keys sorted, name then bytes)
SEEDED_SHA256 = "dddb9b3abb41887826a68cf44b8630c144c158c565115ba5464f2776b36f1dfb"


def tiny_cfg(**kw) -> Config:
    return Config(**{**dict(model="experts_n_est", tiny_backbone=True, num_gaussians=3,
                            gmm_variance=1.0 / 9, num_point=16, patch_radius=(0.05, 0.1, 0.2),
                            seed=5), **kw})


def write_run(path: str, cfg: Config, seed: int, drop: str | None = None) -> dict:
    """A run dir of `cfg` whose checkpoint holds random weights: xavier
    kernels, biases in +-0.1 and BatchNorms whose parameters and moments are
    far from their defaults (gamma in (0.5, 1.5), beta, mean and the EMA
    debias in wide ranges, var in (0.05, 2)).  `drop` leaves that key out of
    the checkpoint.  Returns the checkpoint's state dict."""
    cfg = Config(**{**cfg.__dict__, "log_dir": path})
    rd = RunDir.create(path)
    cfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([cfg.num_gaussians] * 3, variance=cfg.gmm_variance)
    gmm.save(rd.gmm_path)
    g = torch.Generator().manual_seed(seed)
    sd = build_model(cfg, gmm, g).state_dict()

    def draw(v, lo, hi):
        return lo + (hi - lo) * torch.rand(v.shape, generator=g, dtype=torch.float32)

    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        ranges = {"b": (-0.1, 0.1), "gamma": (0.5, 1.5), "beta": (-1.0, 1.0),
                  "ema_mean": (-0.5, 0.5), "ema_var": (0.05, 2.0), "bias": (0.01, 0.9)}
        if leaf in ranges:
            v.copy_(draw(v, *ranges[leaf]))
    if drop is not None:
        del sd[drop]
    checkpoint.save(rd.path, sd)
    return sd


# ---- the host path the port served with, in NumPy (JAX's numbers) ----
def _numpy_fold(w, b, gamma, beta, ema_mean, ema_var, bias, eps=tnn.BN_EPS):
    bias = bias.astype(np.float32)
    denom = np.maximum(1.0 - bias, 1e-12)
    mean = ema_mean.astype(np.float32) / denom
    var = ema_var.astype(np.float32) / denom
    sc = gamma.astype(np.float32) / np.sqrt(var + eps)
    w = w.astype(np.float32) * sc.reshape((-1,) + (1,) * (w.ndim - 1))
    b = (b.astype(np.float32) - mean) * sc + beta.astype(np.float32)
    return w.astype(np.float32), b.astype(np.float32)


def _numpy_quantize(w):
    a = w.astype(np.float32)
    amax = np.max(np.abs(a), axis=tuple(range(1, a.ndim)), keepdims=True)
    scale = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    cout, cin = q.shape[:2]
    q = q.reshape(cout, cin, -1).transpose(0, 2, 1)  # [cout, taps, cin]
    packed = np.zeros((cout, q.shape[1], padded_channels(cin)), np.int8)
    packed[..., :cin] = q
    return packed, scale.reshape(cout).astype(np.float32)


def host_path(sd: dict, fold: bool, quantize: bool) -> dict:
    """{conv/linear module name: {tensor name: array}} as the NumPy host
    path serves the checkpoint `sd`."""
    arrays = {k: v.numpy() for k, v in sd.items()}
    out = {}
    for key in arrays:
        if not key.endswith((".conv.w", ".linear.w")):
            continue
        name = key[: -len(".w")]
        w, b = arrays[name + ".w"], arrays[name + ".b"]
        bn = name.rsplit(".", 1)[0] + ".bn."
        if fold and bn + "gamma" in arrays:
            w, b = _numpy_fold(w, b, *(arrays[bn + p] for p in
                                       ("gamma", "beta", "ema_mean", "ema_var", "bias")))
        if quantize:
            w_q, w_scale = _numpy_quantize(w)
            out[name] = {"w_q": w_q, "w_scale": w_scale, "b": b}
        else:
            out[name] = {"w": w, "b": b}
    return out


def served(model) -> dict:
    """The same dict from a loaded model's conv and linear modules."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (tnn._Conv3D, tnn._Linear)):
            keys = ("w_q", "w_scale", "b") if m.quantized else ("w", "b")
            out[name] = {k: getattr(m, k) for k in keys}
    return out


def assert_host_path(model, sd: dict, dtype: str, fold: bool, device: torch.device):
    """The conv and linear tensors as `host_path` gives them; unfolded, the
    BatchNorms' parameters and moments as the checkpoint holds them."""
    want = host_path(sd, fold, dtype == "int8")
    got = served(model)
    assert set(got) == set(want)
    for name, tensors in want.items():
        assert set(got[name]) == set(tensors), name
        for k, value in tensors.items():
            t, ref = got[name][k], torch.from_numpy(value)
            assert (t.device.type, t.dtype) == (device.type, ref.dtype), (name, k)
            assert torch.equal(t.cpu(), ref), (name, k)
    state = model.state_dict()
    bn_keys = [k for k in sd if ".bn." in k]
    assert bn_keys and set(bn_keys).isdisjoint(state) == fold
    for k in [] if fold else bn_keys:
        assert state[k].device.type == device.type, k
        assert torch.equal(state[k].cpu(), sd[k]), k
    assert model.gmm_w.device.type == device.type


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("load_run") / "run")
    return path, write_run(path, tiny_cfg(), seed=12)


@pytest.mark.parametrize("dtype,fold", MODES)
def test_load_run_serves_the_host_paths_numbers(tiny_run, dtype, fold):
    path, sd = tiny_run
    _, cfg, _, model = load_run(path, torch.device("cpu"), dtype, fold)
    assert (cfg.compute_dtype, cfg.fold_bn, model.training) == (dtype, fold, False)
    assert_host_path(model, sd, dtype, fold, torch.device("cpu"))


def test_load_run_draws_no_weights(tiny_run, monkeypatch):
    """No generator draw: the model is made from the checkpoint alone."""
    import nestinet_tpu_torch.models as models

    def refuse(*args, **kwargs):
        raise AssertionError("load_run initialised the weights")

    monkeypatch.setattr(models, "init_params", refuse)
    monkeypatch.setattr(torch.Tensor, "uniform_", refuse)
    path, sd = tiny_run
    _, _, _, model = load_run(path, torch.device("cpu"), "float32")
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


@pytest.mark.parametrize("drop", ["manager.backbone.incep0.conv1.conv.w",
                                  "experts.6.head.fc2.bn.ema_var"])
def test_a_checkpoint_without_a_parameter_raises(tmp_path, drop):
    """strict `load_state_dict`: nothing initialised fills a missing tensor."""
    path = str(tmp_path / "run")
    write_run(path, tiny_cfg(), seed=3, drop=drop)
    with pytest.raises(RuntimeError, match=f"Missing key.*{drop}"):
        load_run(path, torch.device("cpu"), "int8", True)


def test_build_model_draws_the_seeded_weights():
    """Training's models: `build_model` alone draws xavier kernels from
    `cfg.seed`, the same bytes as before `load_run` stopped drawing; with
    `init=False` every tensor keeps its allocation's zeros and ones, and
    `init_params` with the seeded generator then gives the same model."""
    cfg = tiny_cfg()
    gmm = get_3d_grid_gmm([3, 3, 3], variance=cfg.gmm_variance)
    sd = build_model(cfg, gmm).state_dict()
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == SEEDED_SHA256
    bare = build_model(cfg, gmm, init=False)
    for k, v in bare.state_dict().items():
        want = 1.0 if k.rsplit(".", 1)[-1] in ("gamma", "bias") else 0.0
        assert torch.all(v == want), k
    init_params(bare, torch.Generator().manual_seed(cfg.seed))
    assert all(torch.equal(bare.state_dict()[k], v) for k, v in sd.items())


@pytest.fixture(scope="module")
def card_run(tmp_path_factory):
    """(the card, the full-width flagship's run dir, its state dict); skips
    without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (load_run's preparation on the card)")
    path = str(tmp_path_factory.mktemp("load_run_card") / "run")
    return torch.device("cuda", 0), path, write_run(path, Config(seed=7), seed=21)


@pytest.mark.card
@pytest.mark.parametrize("dtype,fold", MODES)
def test_load_run_on_the_card_serves_the_host_paths_numbers(card_run, dtype, fold):
    """The full-width flagship, loaded on the card in each serving mode:
    every int8 kernel, scale, folded kernel and bias and every float32
    master equal to the NumPy host path's."""
    card, path, sd = card_run
    assert sum(v.numel() for k, v in sd.items()
               if k.rsplit(".", 1)[-1] in ("w", "b", "gamma", "beta")) == 178_382_710
    _, _, _, model = load_run(path, card, dtype, fold)
    assert_host_path(model, sd, dtype, fold, card)
