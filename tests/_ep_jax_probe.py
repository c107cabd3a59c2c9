"""JAX's expert-parallel reference for tests/test_torch_expert_parallel.py.

    python tests/_ep_jax_probe.py IN.npz OUT.npz

Reads a Config's keyword arguments (JSON), the haiku params and state and a
batch from IN.npz, runs `steps` jitted train steps of JAX's trainer path
three times: on one device ("one_device/"), and over a (2 data x 2 expert)
virtual CPU mesh with the mixture-of-experts stacks sharded over "expert"
(`place_train_state(..., moe=True)`, the placement JAX's trainer takes;
"sharded/") and replicated (`moe=False`, "replicated/"), and writes each
step's loss, params and state to OUT.npz.  On XLA:CPU both mesh runs
compute another step than the one device does (see
tests/test_torch_expert_parallel.py).  It runs in a fresh process for the
reason `tests/_moe_multidevice_probe.py` gives: XLA:CPU's in-process
collectives abort the whole process when partitions starve.
"""

import json
import os
import sys

import numpy as np

SEP = "/"


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{SEP}{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The inverse of `flatten` for the keys under `prefix`.  A haiku
    module path holds "/" itself, so the leaf is the last part and the
    top-level key the first."""
    out: dict = {}
    for name, value in flat.items():
        if not name.startswith(prefix + SEP):
            continue
        top, rest = name[len(prefix) + 1:].split(SEP, 1)
        path, leaf = rest.rsplit(SEP, 1)
        out.setdefault(top, {}).setdefault(path, {})[leaf] = value
    return out


def main(src: str, dst: str) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")

    from nestinet_tpu.core.config import Config
    from nestinet_tpu.models import build_model
    from nestinet_tpu.ops.gmm import get_3d_grid_gmm
    from nestinet_tpu.train import train_step as jts
    from nestinet_tpu.train.mesh import make_mesh, shard_batch

    data = dict(np.load(src))
    cfg = Config(**json.loads(str(data.pop("cfg"))))
    steps = int(data.pop("steps"))
    batch = {k[len("batch/"):]: v for k, v in data.items() if k.startswith("batch/")}
    params, state = unflatten(data, "params"), unflatten(data, "state")
    gmm = get_3d_grid_gmm([cfg.num_gaussians] * 3, variance=cfg.gmm_variance)
    model = build_model(cfg, gmm)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    tx = jts.make_optimizer(cfg)
    sb = shard_batch(batch, mesh)
    out = {}
    for placement, moe in (("one_device", None), ("sharded", True), ("replicated", False)):
        p = jax.tree.map(jnp.asarray, params)
        s = jax.tree.map(jnp.asarray, state)
        o = tx.init(p)
        step_fn = jts.jit_train_step(jts.make_train_step(model, cfg, tx))
        if moe is None:
            sb_placed = batch
        else:
            p, s, o = jts.place_train_state(mesh, p, s, o, moe=moe)
            leaf = jax.tree.leaves(p["group0"])[0]
            assert leaf.sharding.is_fully_replicated != moe, placement
            sb_placed = sb
        for i in range(steps):
            p, s, o, loss = step_fn(p, s, o, None, sb_placed, jnp.asarray(i, jnp.int32))
            out[f"{placement}/{i}/loss"] = np.asarray(loss)
            out.update(flatten(jax.tree.map(np.asarray, p), f"{placement}/{i}/params"))
            out.update(flatten(jax.tree.map(np.asarray, s), f"{placement}/{i}/state"))
    np.savez(dst, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
