"""nestinet_tpu_torch: the PyTorch / CUDA port of nestinet_tpu.

The JAX package `nestinet_tpu` is the reference; this package computes the
same functions in PyTorch on an NVIDIA H100 (sm_90a), with every Pallas
kernel of the reference replaced by a hand-written CUDA kernel.  It imports
`torch` and never `jax`: from the reference it reuses only the layers that
are NumPy-only all the way down (`core.config`, `core.rundir`,
`core.textio`, `data`, `eval`).

Layout (each module mirrors its counterpart in `nestinet_tpu/`):
    core/     device resolution, f32 numerics switch, torch checkpoints
    ops/      grid GMM, MuPS statistics (plain + CUDA kernel), NN blocks
    csrc/     CUDA C++ kernel sources, built with nvcc at first use
    models/   backbone specs, the experts_n_est mixture of experts
    infer/    streaming whole-shape inference + .normals writer
    cli/      the inference CLI
    convert   haiku <-> torch weight conversion

This first slice serves a trained `experts_n_est` run dir with dense
float32 mixture-of-experts inference and host (kd-tree) patch extraction.
"""

__version__ = "0.1.0"
