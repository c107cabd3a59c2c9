"""nestinet_tpu_torch: the PyTorch / CUDA port of nestinet_tpu.

The JAX package `nestinet_tpu` is the reference; this package computes the
same functions in PyTorch on an NVIDIA H100 (sm_90a), with every Pallas
kernel of the reference replaced by a hand-written CUDA kernel.  It imports
`torch` and never `jax`, and nothing of `nestinet_tpu`: the host layers it
needs (`core.config`, `core.rundir`, `core.textio`, `data`, `eval`, and
the C++ sampler and text writer in `csrc/`) are its own copies.

Layout (each module mirrors its counterpart in `nestinet_tpu/`):
    core/     device resolution, f32 numerics switch, CUDA-event timing,
              torch checkpoints (periodic and best slots), Config, RunDir,
              the step timer, the native text writer
    data/     PCPNet shape IO, the kd-tree patch dataset, its samplers and
              loader, the native patch sampler, the rotation augmentation,
              the synthetic benchmark generator
    eval/     RMS / PGP scoring of `.normals` files
    ops/      grid GMM, MuPS statistics (plain + CUDA kernels), NN blocks,
              the grid-hash ball query
    csrc/     CUDA C++ kernel sources, built with nvcc at first use, and the
              host C++ sources, built with g++ at first use
    models/   backbone specs, the experts_n_est mixture of experts, losses
    train/    lr and BN-decay schedules, the train and eval steps, the
              trainer (epochs, validation RMS, checkpoints, resume), the
              data mesh and its collectives, the multi-process launcher
    infer/    streaming whole-shape inference (host or device extraction,
              routed or dense MoE) + .normals writer
    cli/      the training and inference CLIs
    scripts/  the blocked-MuPS-kernel experiment
    convert   haiku <-> torch weight conversion

Ported so far: training every model family in float32 or bfloat16 (the
MuPS CUDA kernel in every train and eval step) on one GPU or data-parallel
on several ranks, and serving its run dir in float32, bfloat16 or int8
(optionally with BatchNorm folded), with argmax-only (sparse) or dense
mixture-of-experts inference and host (kd-tree) or device (grid-hash ball
query) patch extraction, on one GPU or data-parallel.
"""

__version__ = "0.1.0"
