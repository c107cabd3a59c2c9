"""What the data-parallel tests run on each rank.

`nestinet_tpu_torch.train.distributed.launch` starts each rank in a new
interpreter and calls a function by its module and name; these live here,
apart from the tests, so that a rank imports torch and the port only, never
JAX.  Each returns what rank 0 hands back to the test.
"""

import time

import numpy as np
import torch

from nestinet_tpu_torch.models import backbones, build_model
from nestinet_tpu_torch.ops import nn as tnn
from nestinet_tpu_torch.ops.gmm import GridGMM
from nestinet_tpu_torch.train import train_step as tts
from nestinet_tpu_torch.train.mesh import make_mesh, shard_batch

# the ablation backbones narrowed as `tests/test_torch_ablations.py::narrow_backbones` does
NARROWED = ("SS_BACKBONE", "MS_BACKBONE_8G", "SW_BACKBONE", "CONV_NET_3G")


def narrow() -> None:
    for name in NARROWED:
        setattr(backbones, name, backbones.TINY)


def sgd_step() -> dict:
    """One data-parallel SGD step of a linear least-squares model: each rank
    takes its rows of an 8-row batch, the loss is the rows' mean squared
    error, and the gradients are averaged over the ranks (as
    `tests/test_distributed_2proc.py`'s worker does in JAX).  Returns every
    rank's updated weights and the ranks' view of the group."""
    mesh = make_mesh()
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(8, 4).astype(np.float32), "y": rng.randn(8).astype(np.float32)}
    local = shard_batch(batch, mesh)
    w = torch.nn.Parameter(torch.arange(4, dtype=torch.float32) / 10.0)
    x, y = torch.from_numpy(local["x"]), torch.from_numpy(local["y"])
    loss = torch.mean((x @ w - y) ** 2)
    loss.backward()
    scalars = mesh.mean_gradients_([w], {"loss": loss.detach()})
    with torch.no_grad():
        w -= 0.1 * w.grad
    return {"w": mesh.all_gather(w.detach().numpy()), "loss": float(scalars["loss"]),
            "world": mesh.size, "rank": mesh.rank}


def sleep(seconds: float) -> None:
    time.sleep(seconds)


def fail_on_rank(rank: int) -> None:
    """Raise on `rank`; the other ranks sleep until they are killed."""
    if make_mesh().rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    time.sleep(600)


def _buffers(model) -> dict:
    return {k: v.clone() for k, v in model.named_buffers()}


def train_case(case: dict) -> dict:
    """`case["steps"]` train steps of the model `case` describes on this
    rank's rows of `case["batch"]`, from `case["state_dict"]`: with the
    data group's global BatchNorm moments, or this rank's own when
    `local_bn` (a control).  Dropout masks, when given, are the global
    batch's per step (`case["masks"]`), each rank keeping its rows.
    Returns, per step, the loss and a copy of the state dict and of the
    optimizer's moments; `buffers` holds every rank's BatchNorm state after
    the last step."""
    if case.get("narrow"):
        narrow()
    cfg = case["cfg"]
    mesh = make_mesh(cfg.data_parallel)
    model = build_model(cfg, GridGMM(*case["gmm"]))
    model.load_state_dict(case["state_dict"])
    model.train()
    tnn.set_moment_sum(model, None if case.get("local_bn") or mesh.size == 1 else mesh.sum)
    opt = tts.make_optimizer(model, cfg)
    step = tts.make_train_step(model, cfg, opt, mesh=mesh)
    batch = case["batch"]
    rows = next(iter(batch.values())).shape[0]
    local = shard_batch(batch, mesh)
    out = []
    for i in range(case["steps"]):
        masks = None
        if case.get("masks") is not None:
            masks = tnn.Dropout(masks=[torch.from_numpy(m) for m in case["masks"][i]],
                                shard=(rows, mesh.rows(rows)))
        loss = step(local, i, masks)
        moments = [{k: v.clone() for k, v in opt.state[p].items()} for p in model.parameters()]
        out.append({"loss": float(loss), "state_dict":
                    {k: v.clone() for k, v in model.state_dict().items()},
                    "moments": moments})
    return {"steps": out, "buffers": mesh.all_gather(_buffers(model))}


def train_cases(cases: list) -> list:
    """`train_case` of each case in turn."""
    return [train_case(case) for case in cases]


def serve_all(run_path: str, root: str, runs: dict) -> dict:
    """Serve `run_path` once per entry of `runs` ({name: (extraction, kwargs)})
    on this rank of a data-parallel group, into `<root>/<name>`; rank 0's
    stats by name."""
    from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
    from nestinet_tpu_torch.infer.predict import predict_shapes

    out = {}
    for name, (extraction, kw) in runs.items():
        fn = predict_shapes_device if extraction == "device" else predict_shapes
        out[name] = fn(run_path, output_dir=f"{root}/{name}", device="cpu",
                       data_parallel=make_mesh().size, **kw)
    return out
