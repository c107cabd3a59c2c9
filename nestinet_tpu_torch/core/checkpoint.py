"""Torch checkpoints of a run directory.

A checkpoint is `torch.save({"state_dict", "optimizer", "step", "epoch"})`
(the optimizer's state dict, or None), read with
`torch.load(weights_only=True)`.  A run dir holds two slots, as the JAX
trainer's `ckpt/` and `ckpt_best/` (`nestinet_tpu/train/trainer.py:253-283`):

    <run>/ckpt_torch/model.pt        the periodic checkpoint; resume reads it
    <run>/ckpt_torch_best/model.pt   the best validation RMS; serving
                                     prefers it when it exists
                                     (JAX `infer/predict.py:164-169`)

Writes are atomic: a temporary file renamed into place.  A payload written
to both slots at once is serialized once, then hard-linked into the second
slot.  Reading the JAX package's msgpack checkpoint (`<run>/ckpt/`) needs
flax and is not ported yet (ROADMAP.md); `convert.from_haiku` turns a
restored haiku tree into this format.
"""

from __future__ import annotations

import os

import torch

CKPT_DIR = "ckpt_torch"
BEST_DIR = "ckpt_torch_best"
CKPT_NAME = "model.pt"


def checkpoint_path(run_path: str, best: bool = False) -> str:
    return os.path.join(run_path, BEST_DIR if best else CKPT_DIR, CKPT_NAME)


def exists(run_path: str, best: bool = False) -> bool:
    return os.path.isfile(checkpoint_path(run_path, best))


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


def load(run_path: str, device: torch.device, best: bool = False) -> dict:
    """{"state_dict", "optimizer", "step", "epoch"}, tensors on `device`."""
    path = checkpoint_path(run_path, best)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no torch checkpoint at {path}")
    return torch.load(path, map_location=device, weights_only=True)


def load_for_serving(run_path: str, device: torch.device) -> dict:
    """The best checkpoint when the trainer wrote one, else the periodic."""
    return load(run_path, device, best=exists(run_path, best=True))
