"""The port's multi-process helpers (`train/distributed.py`, `train/mesh.py`)
against the JAX package's, and a real two-process gloo group.

  * `initialize`, `process_info`, `host_shard` and `host_batch_slice` do
    JAX's arithmetic in one process and in a mocked 4-host layout
    (`tests/test_train_e2e.py:204-236`);
  * `shard_batch` keeps the rows that JAX's `NamedSharding(P("data"))`
    puts on each device;
  * two gloo ranks meet, take one data-parallel SGD step and end with the
    NumPy step's weights on both ranks (`tests/test_distributed_2proc.py`);
  * the launcher kills every rank at its timeout and when one rank fails,
    and refuses NCCL with more ranks than GPUs, naming both counts;
  * the loader's row and batch shards, the dropout shard and BatchNorm's
    moments through a data group's sum equal the one-process ones.
"""

import time
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from nestinet_tpu.train import distributed as jax_distributed
from nestinet_tpu.train.mesh import make_mesh as jax_make_mesh
from nestinet_tpu_torch.data.loader import get_data_loader
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.train import distributed, mesh

from . import test_torch_dp_workers as workers
from .test_torch_trainer import data  # noqa: F401  (the `data` fixture)
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

TIMEOUT = 120  # seconds a launch may take before its ranks are killed


def test_helpers_single_process_match_jax():
    distributed.initialize()  # a no-op at NUM_PROCESSES=1, as JAX's
    jax_distributed.initialize()
    assert distributed.process_info() == (0, 1)
    items = ["a", "b", "c"]
    assert distributed.host_shard(items) == jax_distributed.host_shard(items) == items
    assert distributed.host_batch_slice(64) == jax_distributed.host_batch_slice(64)


@pytest.mark.parametrize("rank", range(4))
def test_helpers_in_a_mocked_4_host_layout_match_jax(rank):
    with mock.patch.object(distributed, "process_info", return_value=(rank, 4)), \
            mock.patch.object(jax_distributed, "process_info", return_value=(rank, 4)):
        assert distributed.host_batch_slice(64) == jax_distributed.host_batch_slice(64)
        assert distributed.host_shard(list(range(10))) == jax_distributed.host_shard(
            list(range(10)))
        with pytest.raises(ValueError):
            distributed.host_batch_slice(63)
        with pytest.raises(ValueError):
            jax_distributed.host_batch_slice(63)
        assert mesh.Mesh(None, rank, 4).rows(64) == distributed.host_batch_slice(64)


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_shard_batch_keeps_the_rows_jax_puts_on_each_device(ranks):
    rng = np.random.RandomState(ranks)
    batch = {"points": rng.randn(16, 5, 3).astype(np.float32),
             "n_eff": rng.randint(0, 5, (16, 1)).astype(np.int32)}
    jmesh = jax_make_mesh(ranks, 1, devices=jax.devices()[:ranks])
    sharded = jax.device_put(batch["points"], NamedSharding(jmesh, PartitionSpec("data")))
    by_device = {s.device: np.asarray(s.data) for s in sharded.addressable_shards}
    for rank, device in enumerate(jmesh.devices[:, 0]):
        got = mesh.shard_batch(batch, mesh.Mesh(None, rank, ranks))
        np.testing.assert_array_equal(got["points"], by_device[device])
        assert got["n_eff"].shape == (16 // ranks, 1)


def test_two_process_gloo_sgd_step_equals_numpy():
    out = distributed.launch(workers.sgd_step, 2, device="cpu", timeout=TIMEOUT)
    assert out["world"] == 2 and out["rank"] == 0
    w_a, w_b = out["w"]
    np.testing.assert_array_equal(w_a, w_b)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 4).astype(np.float32)
    y = rng.randn(8).astype(np.float32)
    w0 = np.arange(4, dtype=np.float32) / 10.0
    grad = 2.0 * x.T @ (x @ w0 - y) / 8.0
    np.testing.assert_allclose(w_a, w0 - 0.1 * grad, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["loss"], np.mean((x @ w0 - y) ** 2), rtol=1e-6)


def test_launch_kills_every_rank_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="every rank was killed"):
        distributed.launch(workers.sleep, 2, (600,), device="cpu", timeout=8)
    assert time.monotonic() - t0 < 60


def test_a_failing_rank_fails_the_launch_and_kills_the_others():
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        distributed.launch(workers.fail_on_rank, 2, (1,), device="cpu", timeout=TIMEOUT)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("visible", [0, 1])
def test_nccl_refuses_more_ranks_than_gpus(visible):
    with mock.patch.object(torch.cuda, "device_count", return_value=visible):
        with pytest.raises(ValueError, match=f"2 local ranks but {visible} visible GPUs"):
            distributed.launch(workers.sleep, 2, (0,), device="cuda")


def test_backends():
    assert distributed.resolve_backend("cpu") == "gloo"
    assert distributed.resolve_backend("cuda") == "nccl"
    assert distributed.resolve_backend("cuda", "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL serves CUDA tensors only"):
        distributed.resolve_backend("cpu", "nccl")
    with pytest.raises(ValueError):
        distributed.resolve_backend("cpu", "mpi")
    # gloo alone shares GPUs between ranks; NCCL takes one a rank
    with mock.patch.object(torch.cuda, "device_count", return_value=1):
        assert distributed.rank_device("cuda", 1, "gloo") == torch.device("cuda", 0)
        assert distributed.rank_device("cuda", 1, "nccl") == torch.device("cuda", 1)
    assert distributed.rank_device("cpu", 1, "gloo") == torch.device("cpu")


def test_make_mesh():
    one = mesh.make_mesh(0)
    assert (one.group, one.rank, one.size, one.parallel) == (None, 0, 1, False)
    assert mesh.make_mesh(1) == one
    for dp, ep in ((1, 2), (2, 1)):  # one process is no world of 2
        with pytest.raises(ValueError, match="distributed.launch"):
            mesh.make_mesh(dp, ep)
    assert (mesh.DATA_AXIS, mesh.EXPERT_AXIS) == ("data", "expert")
    # a mocked world of 6 ranks: rank r at (r // ep, r % ep), as JAX's
    # devices.reshape(dp, ep); every group built on every rank, in order
    made = []

    def new_group(ranks):
        made.append(tuple(ranks))
        return tuple(ranks)

    with mock.patch.object(distributed, "process_info", return_value=(5, 6)), \
            mock.patch.object(mesh.dist, "is_initialized", return_value=True), \
            mock.patch.object(mesh.dist, "new_group", side_effect=new_group):
        m = mesh.make_mesh(3, 2)
        assert (m.rank, m.size, m.expert_rank, m.expert_size) == (2, 3, 1, 2)
        assert m.group == (1, 3, 5) and m.expert_group == (4, 5) and not m.is_main
        assert made == [(0, 2, 4), (1, 3, 5), (0, 1), (2, 3), (4, 5)]
        m = mesh.make_mesh(0, 3)  # data_parallel 0: world // ep
        assert (m.rank, m.size, m.expert_rank, m.expert_size) == (1, 2, 2, 3)
        assert m.group == (2, 5) and m.expert_group == (3, 4, 5)
        for dp, ep in ((2, 2), (4, 2), (0, 4)):  # not dp x ep = 6
            with pytest.raises(ValueError, match="world of 6"):
                mesh.make_mesh(dp, ep)


def _loader(data, **kw):  # noqa: F811
    kwargs = dict(indir=data, batch_size=8, patch_radius=(0.1, 0.2), points_per_patch=12,
                  seed=5, outputs=("unoriented_normals",), patches_per_shape=20, workers=2)
    kwargs.update(kw)
    return get_data_loader("trainingset.txt", **kwargs)[0]


@pytest.mark.parametrize("ranks", [2, 4])
def test_row_shards_concatenate_to_the_global_batches(data, ranks):  # noqa: F811
    whole = list(_loader(data, patch_sample_order="random", drop_last=True))
    parts = [list(_loader(data, patch_sample_order="random", drop_last=True,
                          shard=(r, ranks, "rows"))) for r in range(ranks)]
    assert all(len(p) == len(whole) == len(_loader(data, patch_sample_order="random",
                                                   drop_last=True)) for p in parts)
    for i, batch in enumerate(whole):
        for key, value in batch.items():
            np.testing.assert_array_equal(np.concatenate([p[i][key] for p in parts]), value)


@pytest.mark.parametrize("ranks", [2, 3])
def test_batch_shards_interleave_to_the_global_batches(data, ranks):  # noqa: F811
    whole = list(_loader(data))  # the 'full' order, the last batch partial
    parts = []
    for r in range(ranks):
        loader = _loader(data, shard=(r, ranks, "batches"))
        parts.append(list(loader))
        assert len(loader) == len(parts[-1])
    assert sum(map(len, parts)) == len(whole)
    for i, batch in enumerate(whole):
        for key, value in batch.items():
            np.testing.assert_array_equal(parts[i % ranks][i // ranks][key], value)


def test_bad_shards_raise(data):  # noqa: F811
    with pytest.raises(ValueError, match="drop_last"):
        _loader(data, shard=(0, 2, "rows"))
    with pytest.raises(ValueError, match="bad shard"):
        _loader(data, shard=(2, 2, "batches"))


def test_dropout_shard_keeps_the_rows_of_the_global_masks():
    x = torch.ones(8, 16)
    whole = tnn.Dropout(torch.Generator().manual_seed(3))(x, 0.3)
    for rank in range(2):
        rows = slice(4 * rank, 4 * rank + 4)
        part = tnn.Dropout(torch.Generator().manual_seed(3), shard=(8, rows))(x[rows], 0.3)
        assert torch.equal(part, whole[rows])
        masks = [torch.rand(8, 16) < 0.7]
        replayed = tnn.Dropout(masks=masks, shard=(8, rows))(x[rows], 0.3)
        assert torch.equal(replayed, tnn.Dropout(masks=masks)(x, 0.3)[rows])


def test_batch_norm_moments_through_a_group_sum_equal_local_ones():
    """A world of one's sum is the identity: the sum-based global moments
    equal `mean`/`var` and their gradients to float32 rounding."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 4, 3, 3, 3, generator=gen) * 2 + 1
    out, grads = [], []
    for moment_sum in (None, lambda t: t):
        bn = tnn.BatchNormEMA(4)
        tnn.set_moment_sum(bn, moment_sum)
        xi = x.clone().requires_grad_(True)
        y = bn(xi, training=True, momentum=0.5)
        (y * torch.arange(y.numel()).reshape(y.shape).float().sin()).sum().backward()
        out.append((y.detach(), bn.ema_mean.clone(), bn.ema_var.clone()))
        grads.append(xi.grad)
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)
