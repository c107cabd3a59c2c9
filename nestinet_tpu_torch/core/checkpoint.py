"""Torch checkpoints of a run directory.

The port's format is `torch.save({"state_dict", "step", "epoch"})` at
`<run>/ckpt_torch/model.pt`, written atomically and read with
`torch.load(weights_only=True)`.  Reading the JAX package's msgpack
checkpoint (`<run>/ckpt/`) needs flax and is not ported yet (ROADMAP.md);
`convert.from_haiku` turns a restored haiku tree into this format.
"""

from __future__ import annotations

import os

import torch

CKPT_DIR = "ckpt_torch"
CKPT_NAME = "model.pt"


def checkpoint_path(run_path: str) -> str:
    return os.path.join(run_path, CKPT_DIR, CKPT_NAME)


def save(run_path: str, state_dict: dict, *, step: int = 0, epoch: int = 0) -> str:
    path = checkpoint_path(run_path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "step": int(step),
        "epoch": int(epoch),
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load(run_path: str, device: torch.device) -> dict:
    """{"state_dict", "step", "epoch"}, tensors on `device`."""
    path = checkpoint_path(run_path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no torch checkpoint at {path}")
    return torch.load(path, map_location=device, weights_only=True)
