"""Experiment configuration.

A copy of `nestinet_tpu/core/config.py`, so that the port
imports nothing of the JAX package.

One flat dataclass mirroring the reference's argparse FLAGS
(`train_n_est_w_experts.py:22-64` et al.), serialized to JSON inside the
run directory — replacing the reference's py2 `parameters.p` pickle
(a portability defect we deliberately do not replicate).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# The reference's canonical 7-expert scale assignment
# (`train_n_est_w_experts.py:61-63`).
DEFAULT_EXPERT_DICT = {
    0: [0], 1: [0], 2: [1], 3: [1], 4: [2], 5: [2], 6: [0, 1, 2],
}


@dataclasses.dataclass
class Config:
    # experiment
    model: str = "experts_n_est"
    log_dir: str = "log/my_experts"
    desc: str = "nestinet_tpu training run"
    seed: int = 3627473

    # data (PCPNet patch pipeline)
    data_path: str = "data/pcpnet/"
    trainset: str = "trainingset_whitenoise.txt"
    testset: str = "validationset.txt"
    patch_radius: tuple = (0.01, 0.03, 0.05)
    num_point: int = 512
    patches_per_shape: int = 1024
    identical_epochs: bool = False
    patch_center: str = "point"
    use_pca: bool = False
    point_tuple: int = 1  # n-tuples of points as input (provider.py:341)
    patch_point_count_std: float = 0.0
    cache_capacity: int = 100
    insert_rotation_augmentation: bool = False
    outputs: tuple = ("unoriented_normals",)

    # GMM grid
    num_gaussians: int = 8  # grid subdivisions per axis (K = n^3)
    gmm_variance: float = 0.0156

    # optimization (reference defaults from the canonical exec line)
    batch_size: int = 64
    max_epoch: int = 1000
    learning_rate: float = 1e-4
    momentum: float = 0.9
    optimizer: str = "adam"
    decay_step: int = 491520
    decay_rate: float = 0.7
    lr_min: float = 1e-6
    weight_decay: float = 0.0
    loss_type: str = "sin"

    # BN decay schedule (`train_n_est_w_experts.py:127-130`)
    bn_init_decay: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_clip: float = 0.99

    # mixture of experts
    n_experts: int = 7
    expert_loss_type: str = "simple"
    expert_dict: dict = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_EXPERT_DICT)
    )

    # TPU execution
    data_parallel: int = 1  # chips along the batch ("data") mesh axis
    expert_parallel: int = 1  # chips along the expert mesh axis (MoE only)
    compute_dtype: str = "float32"  # CNN compute: float32 | bfloat16 | int8 (serving only)
    # Fold eval BatchNorm affines into conv/linear kernels at checkpoint
    # load (ops/fold.py).  Serving-only: the trainer force-clears it.
    fold_bn: bool = False
    # MuPS statistics implementation: "auto" picks the fused Pallas
    # kernel on TPU backends and the XLA broadcast+reduce path elsewhere.
    mups_impl: str = "auto"  # auto | jnp | pallas
    # Replace every CNN backbone with a single tiny inception block.
    # For mesh/sharding dryruns and compile-bound tests ONLY: the model
    # keeps its full structure (MuPS, manager+softmax gate, grouped
    # vmap-stacked experts, FC heads, losses, optimizer) so SPMD
    # partitioning, collectives and the optimizer are exercised, but
    # XLA:CPU codegen drops from minutes to seconds on small hosts.
    tiny_backbone: bool = False

    # checkpointing
    checkpoint_every: int = 10  # epochs
    # Capture a jax.profiler device trace (TensorBoard/Perfetto) of this
    # epoch into <run>/profile/ (-1 disables).  The reference had no
    # profiling subsystem at all (SURVEY §5).
    profile_epoch: int = -1

    # ---- derived helpers ----
    @property
    def n_scales(self) -> int:
        return len(self.patch_radius)

    @property
    def expert_assignment(self) -> dict[int, list[int]]:
        """{expert index -> sorted scale list}, with the reference's
        default derivation when unspecified (`experts_n_est.py:82-95`)."""
        if self.expert_dict:
            return {int(k): sorted(v) for k, v in self.expert_dict.items()}
        n_rads = self.n_scales
        ratio, rem = divmod(self.n_experts, n_rads)
        assignment = []
        for i in range(n_rads):
            assignment.extend([[i]] * ratio)
        assignment.extend([list(range(n_rads))] * rem)
        return {i: assignment[i] for i in range(self.n_experts)}

    # ---- serialization ----
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["patch_radius"] = list(self.patch_radius)
        d["outputs"] = list(self.outputs)
        d["expert_dict"] = {str(k): v for k, v in self.expert_dict.items()}
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        d = json.loads(text)
        return Config.from_dict(d)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "Config":
        known = {f.name for f in dataclasses.fields(Config)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "patch_radius" in kwargs:
            kwargs["patch_radius"] = tuple(kwargs["patch_radius"])
        if "outputs" in kwargs:
            kwargs["outputs"] = tuple(kwargs["outputs"])
        if "expert_dict" in kwargs and kwargs["expert_dict"] is not None:
            kwargs["expert_dict"] = {
                int(k): list(v) for k, v in kwargs["expert_dict"].items()
            }
        return Config(**kwargs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "Config":
        with open(path) as f:
            return Config.from_json(f.read())
