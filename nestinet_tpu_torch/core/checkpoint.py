"""Checkpoints of a run directory: the port's own, and the JAX trainer's.

A torch checkpoint is `torch.save({"state_dict", "optimizer", "step",
"epoch"})` (the optimizer's state dict, or None), read with
`torch.load(weights_only=True, mmap=True)`.  A run dir holds two slots,
as the JAX trainer's `ckpt/` and `ckpt_best/`
(`nestinet_tpu/train/trainer.py:253-283`):

    <run>/ckpt_torch/model.pt        the periodic checkpoint; resume reads it
    <run>/ckpt_torch_best/model.pt   the best validation RMS; serving
                                     prefers it when it exists
                                     (JAX `infer/predict.py:164-169`)

Writes are atomic: a temporary file renamed into place.  A payload written
to both slots at once is serialized once, then hard-linked into the second
slot.

A run dir that the JAX trainer wrote holds `<run>/ckpt/` and maybe
`<run>/ckpt_best/`, each a flax msgpack blob of {"params", "state",
"opt_state"} beside `model.meta.json` ({"step", "epoch", "file"};
`nestinet_tpu/core/checkpoint.py:129-145`).  `load` and `load_for_serving`
read it, through `core/flax_msgpack.py` and `convert.from_haiku`, when the
run dir holds no torch checkpoint in either slot: serving prefers
`ckpt_best/` as JAX's `restore_model` does, resume reads `ckpt/`.  When
both kinds exist, the torch checkpoint wins: it is what the port wrote
last (a JAX run resumed by the port continues in `ckpt_torch/`, and the
resume first copies JAX's `ckpt_best/` into `ckpt_torch_best/`, so that
serving keeps JAX's best until a resumed epoch beats it).  A JAX
payload carries the optax state as a haiku-shaped tree under
"optax_state" and "optimizer" None; `convert.optimizer_state_from_optax`
turns it into the torch optimizer's state once the model exists.
"""

from __future__ import annotations

import json
import os

import torch

CKPT_DIR = "ckpt_torch"
BEST_DIR = "ckpt_torch_best"
CKPT_NAME = "model.pt"
JAX_CKPT_DIR = "ckpt"
JAX_BEST_DIR = "ckpt_best"
JAX_META_NAME = "model.meta.json"


def checkpoint_path(run_path: str, best: bool = False) -> str:
    return os.path.join(run_path, BEST_DIR if best else CKPT_DIR, CKPT_NAME)


def exists(run_path: str, best: bool = False) -> bool:
    return os.path.isfile(checkpoint_path(run_path, best))


def jax_meta_path(run_path: str, best: bool = False) -> str:
    return os.path.join(run_path, JAX_BEST_DIR if best else JAX_CKPT_DIR, JAX_META_NAME)


def jax_exists(run_path: str, best: bool = False) -> bool:
    return os.path.isfile(jax_meta_path(run_path, best))


def has_torch_checkpoint(run_path: str) -> bool:
    return exists(run_path) or exists(run_path, best=True)


def resumable(run_path: str) -> bool:
    """A periodic checkpoint to resume from: the port's, or JAX's when the
    run dir holds no torch checkpoint."""
    return exists(run_path) or (not has_torch_checkpoint(run_path) and jax_exists(run_path))


def save(run_path: str, state_dict: dict, *, optimizer: dict | None = None, step: int = 0,
         epoch: int = 0, periodic: bool = True, best: bool = False) -> list[str]:
    """Write the checkpoint into the periodic slot, the best slot or both;
    returns the paths written."""
    paths = [checkpoint_path(run_path, b) for b, on in ((False, periodic), (True, best)) if on]
    if not paths:
        return []
    payload = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "optimizer": optimizer,
        "step": int(step),
        "epoch": int(epoch),
    }
    for i, path in enumerate(paths):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)
        if i == 0:
            torch.save(payload, tmp)
        else:
            os.link(paths[0], tmp)
        os.replace(tmp, path)
    return paths


def load_jax(run_path: str, cfg, best: bool = False) -> dict:
    """The JAX trainer's checkpoint in `<run>/ckpt/` (or `ckpt_best/`) as
    {"state_dict" (CPU tensors, converted for `cfg`'s model), "optimizer":
    None, "optax_state" (the decoded optax tree), "step", "epoch"}."""
    from .. import convert
    from . import flax_msgpack

    meta_path = jax_meta_path(run_path, best)
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"no JAX checkpoint at {os.path.dirname(meta_path)}")
    with open(meta_path) as f:
        meta = json.load(f)
    tree = flax_msgpack.load(os.path.join(os.path.dirname(meta_path), meta["file"]))
    return {
        "state_dict": convert.from_haiku(tree["params"], tree["state"], cfg),
        "optimizer": None,
        "optax_state": tree["opt_state"],
        "step": int(meta["step"]),
        "epoch": int(meta["epoch"]),
    }


def load(run_path: str, device: torch.device, best: bool = False, cfg=None) -> dict:
    """{"state_dict", "optimizer", "step", "epoch"}, tensors on `device`.
    A torch checkpoint's tensors are mapped from its file, copy on write,
    and not read into memory first: on the CPU they stay mapped, elsewhere
    they are copied to `device` from the map.  Without a torch checkpoint in
    the run dir, the JAX trainer's in the same slot, converted for `cfg`
    (see `load_jax`)."""
    path = checkpoint_path(run_path, best)
    if os.path.isfile(path):
        return torch.load(path, map_location=device, weights_only=True, mmap=True)
    if cfg is not None and not has_torch_checkpoint(run_path) and jax_exists(run_path, best):
        payload = load_jax(run_path, cfg, best)
        payload["state_dict"] = {k: v.to(device) for k, v in payload["state_dict"].items()}
        return payload
    raise FileNotFoundError(f"no torch checkpoint at {path}"
                            + ("" if cfg is None else " and no JAX checkpoint to read"))


def load_for_serving(run_path: str, device: torch.device, cfg=None) -> dict:
    """The best checkpoint when the trainer wrote one, else the periodic;
    the torch trainer's when the run dir holds one, else (given `cfg`) the
    JAX trainer's."""
    if has_torch_checkpoint(run_path) or cfg is None:
        return load(run_path, device, best=exists(run_path, best=True))
    return load(run_path, device, best=jax_exists(run_path, best=True), cfg=cfg)
