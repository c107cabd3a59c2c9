"""nestinet_tpu_torch: the PyTorch / CUDA port of nestinet_tpu.

The JAX package `nestinet_tpu` is the reference; this package computes the
same functions in PyTorch on an NVIDIA H100 (sm_90a), with every Pallas
kernel of the reference replaced by a hand-written CUDA kernel.  It imports
`torch` and never `jax`: from the reference it reuses only the layers that
are NumPy-only all the way down (`core.config`, `core.rundir`,
`core.textio`, `data`, `eval`).

Layout (each module mirrors its counterpart in `nestinet_tpu/`):
    core/     device resolution, f32 numerics switch, CUDA-event timing,
              torch checkpoints
    ops/      grid GMM, MuPS statistics (plain + CUDA kernels), NN blocks,
              the grid-hash ball query
    csrc/     CUDA C++ kernel sources, built with nvcc at first use
    models/   backbone specs, the experts_n_est mixture of experts
    infer/    streaming whole-shape inference (host or device extraction,
              routed or dense MoE) + .normals writer
    cli/      the inference CLI
    scripts/  the blocked-MuPS-kernel experiment
    convert   haiku <-> torch weight conversion

Ported so far: serving a trained `experts_n_est` run dir in float32, with
argmax-only (sparse) or dense mixture-of-experts inference and host
(kd-tree) or device (grid-hash ball query) patch extraction.
"""

__version__ = "0.1.0"
