"""The port's flax-free reader of the JAX trainer's msgpack checkpoints.

`nestinet_tpu_torch/core/flax_msgpack.py` decodes what
`flax.serialization.to_bytes` writes without flax or msgpack.  Held here:
  * on trees of every leaf type flax writes (arrays of several dtypes and
    shapes, 0-d arrays, NumPy scalars, ints of every width, floats, strings,
    booleans, None, maps and arrays past the fixed and 16-bit sizes, and an
    array chunked under `__msgpack_chunked_array__`), the decoded tree
    equals `flax.serialization.msgpack_restore` leaf for leaf, bit for bit;
  * for each of the four model families, a checkpoint that JAX's
    `core/checkpoint.py::save` writes on the CPU after two adam steps decodes
    equal, leaf for leaf and bit for bit, to `flax.serialization.from_bytes`
    with the trainer's template;
  * the run dir that holds it is served by the port's `load_run`: normals
    (and the switching model's noise estimate) within atol 1e-5 of JAX's on
    the same batch;
  * the port's trainer resumes it (weights, BatchNorm state, step, epoch,
    adam's moments) and its next step equals JAX's next step at the bars
    of `tests/test_torch_train_step.py`;
  * which checkpoint wins: a torch checkpoint over JAX's, `ckpt_best/` over
    `ckpt/` for serving, `ckpt/` for resume.
"""

import json
import os

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nestinet_tpu.core import checkpoint as jax_ckpt
from nestinet_tpu.core.rundir import RunDir as JaxRunDir
from nestinet_tpu.models import build_model as jax_build_model
from nestinet_tpu.train import train_step as jts
from nestinet_tpu_torch.core import checkpoint, flax_msgpack
from nestinet_tpu_torch.core.rundir import RunDir
from nestinet_tpu_torch.infer.predict import load_run
from nestinet_tpu_torch.train.trainer import Trainer

from .test_torch_ablation_train import check_step
from .test_torch_ablations import (ABLATIONS, ablation_cfgs, make_batch, narrow_backbones,
                                   port_eval, random_bn_flat)
from .test_torch_experts import random_bn
from .test_torch_train_step import bn_fed_biases
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

FAMILIES = sorted(ABLATIONS) + ["experts_n_est"]
LR = 1e-3
EXPERTS = {0: [0], 1: [1], 2: [0, 1, 2]}


def assert_trees_equal(got, want, path=""):
    """Leaf for leaf: the same keys, and arrays of the same dtype, shape and
    bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


# ------------------------------------------------------------- the format


def _every_type_tree(rng):
    return {
        "f32": rng.normal(size=(3, 4, 5)).astype(np.float32),
        "f64": rng.normal(size=(7,)),
        "i32": rng.randint(-5, 5, size=(2, 2)).astype(np.int32),
        "u8": rng.randint(0, 255, size=(300,)).astype(np.uint8),
        "bool": rng.rand(9) > 0.5,
        "zero_d": np.asarray(np.float32(2.5)),
        "empty": np.zeros((0, 3), np.float32),
        "scalars": {"np_f32": np.float32(1.25), "np_i64": np.int64(-7), "np_u16": np.uint16(9)},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129, -40000,
                 -(2**31) - 1],
        "floats": [0.5, -1e300, float("inf")],
        "strings": ["", "x", "é" * 40, "s" * 70_000],
        "flags": [True, False, None],
        "wide_map": {str(i): i for i in range(40)},
        "wide_list": list(range(20)),
        "big_map": {str(i): np.int8(i % 100) for i in range(70_000)},
        "nested": [np.arange(3, dtype=np.int16), {"t": "u"}],
    }


def test_decoder_equals_msgpack_restore_on_every_type():
    tree = _every_type_tree(np.random.RandomState(0))
    blob = fser.msgpack_serialize(tree)
    assert_trees_equal(flax_msgpack.loads(blob), fser.msgpack_restore(blob))
    arr = flax_msgpack.loads(blob)["f32"]
    assert not arr.flags.writeable and arr.base is not None  # a view of the blob


def test_decoder_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(1000, dtype=np.float32).reshape(10, 100),
            "nested": {"w": np.arange(50, dtype=np.float64)}, "small": np.ones(3, np.float32)}
    blob = fser.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = flax_msgpack.loads(blob)
    assert_trees_equal(got, fser.msgpack_restore(blob))
    np.testing.assert_array_equal(got["big"], tree["big"])


def test_decoder_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.loads(fser.msgpack_serialize({"x": jnp.ones(3, jnp.bfloat16)}))
    with pytest.raises(ValueError, match="ext type 2"):
        flax_msgpack.loads(fser.msgpack_serialize({"c": 1 + 2j}))
    blob = fser.msgpack_serialize({"x": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.loads(blob + b"\x00")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(blob[:-4])


# ------------------------------------------------ JAX-written run dirs


def family_cfgs(model, log_dir, data_path=""):
    kw = dict(log_dir=log_dir, data_path=data_path, learning_rate=LR, decay_step=16,
              decay_rate=0.7)
    if model == "experts_n_est":
        from nestinet_tpu.core.config import Config as JaxConfig

        from nestinet_tpu_torch.core.config import Config

        base = dict(model=model, tiny_backbone=True, num_point=16, num_gaussians=3,
                    gmm_variance=1.0 / 9, patch_radius=(0.01, 0.03, 0.05), n_experts=3,
                    expert_dict=EXPERTS, batch_size=8, loss_type="sin", **kw)
        return Config(**base), JaxConfig(**base)
    return ablation_cfgs(model, **kw)


def write_jax_run(root, model, steps=2):
    """A JAX run dir after `steps` adam steps on one batch: config, GMM and
    `ckpt/` (epoch 0); returns (cfg, jcfg, gmm, path, batch, (params, state,
    opt_state))."""
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm

    cfg, jcfg = family_cfgs(model, os.path.join(root, model))
    rd = JaxRunDir.create(jcfg.log_dir)
    jcfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([3, 3, 3], variance=jcfg.gmm_variance)
    gmm.save(rd.gmm_path)
    batch = make_batch(jcfg.n_scales, 21)
    jm = jax_build_model(jcfg, gmm)
    params, state = jax.jit(jm.init)(jax.random.PRNGKey(2), batch)
    params, state = jax.device_get((params, state))
    rng = np.random.RandomState(3)
    if model == "experts_n_est":
        params, state = random_bn(params, state, rng)
    else:
        params, state = random_bn_flat(params, state, rng)
    tx = jts.make_optimizer(jcfg)
    opt = tx.init(params)
    step_fn = jax.jit(jts.make_train_step(jm, jcfg, tx))
    for i in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(jcfg.seed + 1), i)
        params, state, opt, _ = step_fn(params, state, opt, key, batch,
                                        jnp.asarray(i, jnp.int32))
    jax_ckpt.save(rd.ckpt_dir, params=params, state=state, opt_state=opt, step=steps, epoch=0)
    return cfg, jcfg, gmm, rd.path, batch, jax.device_get((params, state, opt))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jax_runs"))
    with narrow_backbones():
        return {m: write_jax_run(root, m) for m in FAMILIES}


@pytest.mark.parametrize("model", FAMILIES)
def test_checkpoint_decodes_as_flax_restores_it(jax_runs, model):
    _, jcfg, gmm, path, batch, _ = jax_runs[model]
    ckpt = os.path.join(path, "ckpt")
    with open(os.path.join(ckpt, "model.meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(ckpt, meta["file"]), "rb") as f:
        blob = f.read()
    with narrow_backbones():
        jm = jax_build_model(jcfg, gmm)
        p_t, s_t = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch)
    o_t = jax.eval_shape(jts.make_optimizer(jcfg).init, p_t)
    template = {"params": jax_ckpt._template(p_t), "state": jax_ckpt._template(s_t),
                "opt_state": jax_ckpt._template(o_t)}
    want = fser.to_state_dict(fser.from_bytes(template, blob))
    got = flax_msgpack.loads(blob)
    assert_trees_equal(got, want)
    assert set(got["opt_state"]["0"]) == {"count", "mu", "nu"}
    assert int(got["opt_state"]["0"]["count"]) == meta["step"] == 2


@pytest.mark.parametrize("model", FAMILIES)
def test_port_serves_a_jax_run_dir(jax_runs, model):
    cfg, jcfg, gmm, path, batch, (params, state, _) = jax_runs[model]
    assert not checkpoint.has_torch_checkpoint(path)
    with narrow_backbones():
        jm = jax_build_model(jcfg, gmm)
        want, _ = jax.jit(lambda p, s, b: jm.apply(p, s, None, b, False, 0.0))(
            params, state, batch)
        _, _, _, ported = load_run(path, torch.device("cpu"), compute_dtype="float32")
    got = port_eval(ported, batch)
    for key in ("n_pred", "noise_pred", "experts_prob"):
        if key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["ms_sw_n_est", "experts_n_est"])
def test_port_resumes_a_jax_run_dir(jax_runs, model):
    """The trainer resumes JAX's `ckpt/` at its step and epoch with adam's
    moments; its next step equals JAX's next step."""
    cfg, jcfg, gmm, path, batch, (params, state, opt) = jax_runs[model]
    with narrow_backbones():
        jm = jax_build_model(jcfg, gmm)
        tx = jts.make_optimizer(jcfg)
        p, s, o, loss = jax.jit(jts.make_train_step(jm, jcfg, tx))(
            params, state, opt, None, batch, jnp.asarray(2, jnp.int32))
        trainer = Trainer(cfg, run_dir=RunDir.open(path), device="cpu")
    trainer.restore()
    assert (trainer.step, trainer.start_epoch) == (2, 1)
    got = trainer._train_step(batch, trainer.step)
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    want = (float(loss), jax.device_get(p), jax.device_get(s), o, None)
    check_step(trainer.model, cfg, trainer.optimizer, want, 3, bn_fed_biases(trainer.model))


def test_which_checkpoint_wins(jax_runs, tmp_path):
    import shutil

    cfg, _, _, path, _, _ = jax_runs["ss_norm_est"]
    run = str(tmp_path / "run")
    shutil.copytree(path, run)
    cpu = torch.device("cpu")
    assert checkpoint.resumable(run) and not checkpoint.exists(run)
    with pytest.raises(FileNotFoundError):
        checkpoint.load(run, cpu)  # a JAX checkpoint needs the config to convert
    jax_sd = checkpoint.load(run, cpu, cfg=cfg)["state_dict"]
    # serving prefers ckpt_best/, resume reads ckpt/
    shutil.copytree(os.path.join(run, "ckpt"), os.path.join(run, "ckpt_best"))
    with open(os.path.join(run, "ckpt_best", "model.meta.json")) as f:
        meta = json.load(f)
    meta["epoch"] = 7
    with open(os.path.join(run, "ckpt_best", "model.meta.json"), "w") as f:
        json.dump(meta, f)
    assert checkpoint.load_for_serving(run, cpu, cfg)["epoch"] == 7
    assert checkpoint.load(run, cpu, cfg=cfg)["epoch"] == 0
    # a torch checkpoint in either slot wins over both of JAX's
    zeros = {k: torch.zeros_like(v) for k, v in jax_sd.items()}
    checkpoint.save(run, zeros, step=5, epoch=3, periodic=False, best=True)
    assert not checkpoint.resumable(run)
    served = checkpoint.load_for_serving(run, cpu, cfg)
    assert served["epoch"] == 3 and all(v.abs().max() == 0 for v in served["state_dict"].values())
    with pytest.raises(FileNotFoundError):
        checkpoint.load(run, cpu, cfg=cfg)  # resume reads only the port's slot now
