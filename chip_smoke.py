#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`nestinet_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):
  1. device: require CUDA, print the card's name and power limit, turn
     TF32 off (the JAX reference computes in float32);
  2. build: compile the five CUDA libraries (`csrc/mups_kernel.cu`, the
     two MuPS kernels; `csrc/int8_conv.cu`, the int8 convs, k > 1;
     `csrc/int8_gemm.cu`, the int8 GEMM of the k = 1 layers;
     `csrc/max_pool.cu`, the backbones' max pool; `csrc/avg_pool.cu`, the
     Inception blocks' average pool) with nvcc into the
     gitignored build directory, one nvcc per library, started together;
     print their ptxas lines;
  3. MuPS kernel (one row per ticket of a persistent grid) against its
     plain PyTorch version at the serving shapes (384 and 768 rows of 512
     points, 512 Gaussians), unpadded, randomly padded and with n_eff = 0
     rows, at atol 1e-5; its gradient at a small shape at atol 1e-4; both
     kernels on 256 random rows with 10^3 Gaussians (the instance for
     K > 512) at atol 1e-5, the blocked one identical to kernel 1;
  4. blocked MuPS kernel at 768 rows for block_b in {1, 2, 4, 8}: against
     the plain version at atol 1e-5 on the same three row sets, and against
     the first kernel (identical); 766 rows in blocks of 4 raise; then its
     entry point, `nestinet_tpu_torch.scripts.mups_kernel_exp.main`; then
     both kernels on the 768 rows of one served batch at PCPNet's density
     (`mups_kernel_parts.served_rows`: 256 patches x 3 radii extracted on
     the card from a 100,000-point synthetic sphere, n_eff about 31, 270 and
     512), held the same way and timed;
  5. the fused int8 kernels (bf16 in, quantized on load, wgmma; ReLU and
     max|out| in the epilogue) against their plain version (the quantize
     pass, an exact integer conv in float64 and the same float32 epilogue)
     at every distinct conv of the flagship manager, both expert widths and
     the switching model's `SW_BACKBONE` (20 channels in; the 5^3 convs on
     the 4^3 grid) and every FC layer, each at B = 256 and at a routed
     sub-batch of 37 (the FCs and the 2^3 grid's convs also at 64 and 1,
     the switching model's layers at 64, the router's padded run), ReLU
     off and on,
     each with a forwarded bound and with the scale from max|x|: outputs
     and max|out| identical, and each call launched the kernel
     `int8_cuda.kernel_for` names and no other (the GEMM at every 1x1x1
     conv and FC, the conv kernels above); each shape timed (CUDA events)
     beside its bound, its kernel, tile and cluster, with `torch._int_mm` on
     the same int8 operands as the yardstick at the 1x1x1 convs and FCs;
     the plain version's time at the widest conv and the widest k = 1
     layer;
 5b. the max pool kernel against aten's `F.max_pool3d` (the plain version,
     behind its -inf pad) at every pool of the served backbones, of
     CONV_NET_3G and of TINY, at B = 256, 37, 64 and 1024, and at three
     shapes of the element-wise kernel at B = 37, in bfloat16 and float32
     with NaN (two payloads), -inf and signed zeros planted: bits
     identical, one launch a call; at B = 256 and 1024 in bfloat16 each
     served shape timed on the device beside its byte bound, the plain
     version and aten's pool alone (`library_ms`), with the launches a call
     of each; every serving path
     below must launch the kernel, phase 11 counts one launch a pool in one
     manager call and one expert run (3 and 3) in each dtype, and phase 14a
     two a CNN of each ablation model;
 5c. the average pool kernel against its plain version
     (`avg_pool3d_reference`: aten's +0 pad, the separable adds in D, H, W
     order, TensorFlow's divisor, the divide and aten's ReLU) at every
     Inception block's pool of the nets of 5b on 60 and 20 channels, at
     B = 256 and 1024, and at six shapes of the cell-by-cell kernel at
     B = 37, in bfloat16 and float32, ReLU off and on, with NaN (two
     payloads), +-inf, signed zeros, overflowing and subnormal volumes
     planted: bits identical, one launch a call; at B = 256 and 1024 in
     bfloat16 each served shape timed on the device beside its byte bound
     and the plain version; it prints aten's ReLU of -0 on the card (+0,
     which the kernel's ReLU gives too); every serving path below must
     launch the kernel, and phase 11 counts one launch an Inception block
     (6 a manager call, 4 an expert run) in each dtype;
  6. device extraction: one batch of 256 queries per radius of the
     flagship config on one synthetic shape, extracted on the card and on
     the CPU from the same inputs: grids, selected rows, hit masks and
     n_eff identical;
  7. the routed slice: a full-width `experts_n_est` run dir (3 radii, 512
     points, 8^3 Gaussians, 7 experts, random weights and BatchNorm state
     from a seed, the manager's last layer rescaled so that patches route
     to several experts) serves the 6-shape synthetic testset (30,000
     patches) in float32 through `predict_shapes_device` (device
     extraction, argmax-only routing on JAX's schedule, batch 256): one
     MuPS launch per batch, finite normals, ids in [0, 7), a finite RMS
     from `eval/evaluate.py`; every routed path prints its router's expert
     runs, forced flushes and window;
  8. the host routed path (`predict_shapes`, kd-tree extraction, batch
     128) on the same run dir and two of the shapes (10,000 patches),
     checked the same way;
  9. the host dense path on one of the shapes, checked the same way; then
     one device-extracted batch routed and dense (identical ids, normals at
     atol 1e-4) and one host batch against the same model on the plain
     MuPS;
 10. the serving dtypes: device-sparse in bfloat16, in bfloat16 with
     BatchNorm folded, in int8 and in int8 with BatchNorm folded (the mode
     JAX serves after `restore_model` folds, then quantizes), each on the
     30,000 patches, checked as in phase 7; the int8 paths must launch the
     int8 kernels, once a conv or linear layer of the manager a batch and
     of the expert a run, the GEMM once a layer `kernel_for` sends it (17
     and 12 of the 28 and 20) (`int8_calls`, `check_int8_launches`), and the
     others must not;
 11. one device batch in each dtype, routed and dense: manager ids
     identical (under int8 too: the manager sees the same batch), bfloat16
     normals within 5% of the largest |normal| (cuDNN may sum a sub-batch
     in another order); each dtype's agreement with float32 printed, not
     held (random weights); the manager's time and its device-time split
     (convolutions, int8 kernels, the GEMM) in each dtype, and under int8
     an expert run's; under int8 the device launches of one batch routed on
     its own through the router (`route_one`) and of one conv
     (`torch.profiler`), and
     each int8 kernel's own count of one manager call and of one expert
     run, held to the layers (`int8_calls`);
 12. times: both MuPS kernels and their plain version (CUDA events, median
     after warm-up) on random and on served rows, each beside its bound,
     extraction per batch, the forward, and each serving path's patches/s
     and peak memory;
 13. training, at full width: (a) one float32 train step on the card
     against the same step on the CPU, from the same weights and one batch
     of 16 patches at PCPNet's density with random normals as targets: the
     loss at rtol 1e-5, the BatchNorm state at atol 1e-5, the gradients
     within 4x of what moving the CPU's input points by 1e-7 relative does
     to them (measured in the run); the step launches the MuPS kernel once
     and never calls the plain MuPS backward, the eval step launches it
     once; (b) the train step at B = 256 (or the largest batch that fits)
     in float32 and bfloat16 on one fixed batch: ms per step (CUDA events,
     the median of steps 3-10), patches/s, peak memory, MuPS launches per
     step and the MuPS kernel's share; the loss after the last adam step
     (10 in float32, 20 in bfloat16) below the first step's; (c)
     `python -m nestinet_tpu_torch.cli.train` on the synthetic training and
     validation sets (18 and 6 shapes, 64 patches each, B = 256: 4 steps an
     epoch) for 2 epochs with `--profile_epoch 1`, then `--max_epoch 3
     --resume 1` in place on 4 of the 18 training shapes (one step), then
     `python -m nestinet_tpu_torch.cli.test
     --extraction=device` serves the run's best checkpoint on two test
     shapes: finite normals and RMS; the run's TensorBoard events, read with
     the port's own framing and CRC, hold every numeric scalar of its
     `metrics.jsonl`, and the trace in `<run>/profile/` names
     `tdmfv_n_est_kernel` once per train step of epoch 1 (the traced
     epoch's step times printed beside the untraced ones);
 14. the ablation models (`models/ss.py`, `ms.py`, `switching.py`), each at
     the full width of its JAX definition with 512 points and 8^3
     Gaussians, random weights and BatchNorm state from a seed: the
     single-scale model on the flagship's middle radius (0.03), the
     multi-scale one on all three, the switching one on the smallest and
     largest (its noise head rescaled on one batch so that both branches
     are taken).  (a) Each serves one of the six test shapes (5,000
     patches) through `predict_shapes_device` in float32 and bfloat16
     (the switching model routed, the default, and in bfloat16 also dense,
     `moe_inference="dense"`: its normals held to the routed run's within 5%
     of max |normal| on the rows clear of the switch), the
     single-scale model also in int8 with BatchNorm folded, which must
     launch the int8 kernels once a layer a batch (the GEMM once a 1x1x1 conv
     or linear): one MuPS launch a batch, finite `.normals`, no `.experts`
     but the switching model's (served routed: a branch id a patch), a
     finite RMS, patches/s and peak memory; the switching
     model's share of served patches in each branch is printed, and a
     branch that serves none fails the run; one device batch is held
     against the same model on the plain MuPS at atol 1e-4 in float32.  (b) Each model's float32
     train step at B = 256 is timed as in 13b over 6 steps (the median of
     steps 3-6); then `cli.train --model ...` runs 1 epoch at B = 256 (the
     single- and multi-scale models on
     the synthetic training and validation sets, 4 steps an epoch; the
     switching model on the switching benchmark at 2,000 points a shape,
     32 patches a shape, 3 steps an epoch), the three at once (their
     float32 step peaks sum to about half the card), and `cli.test
     --extraction=device` serves each trained run on one shape (the
     switching model's on two of its benchmark).  (c) `cli.test` serves the run
     dir that the JAX package wrote (`nestinet_tpu_torch/testdata/
     jax_run_moe3/`, read by the flax-free msgpack reader) on the card in
     float32: normals within atol 1e-4 of the ones JAX served on the CPU.
  15. the scan and the CLIs, on phase 7's run dir (float32): (a) a
     240 x 320 depth frame made from the seed (a floor, a wall and a sphere
     ray-cast with ScanNet's depth intrinsics halved, millimetres, about 10%
     holes, a pose with a rotation and a translation; about 69,000 points)
     served whole by `infer/scan.py::predict_scan` with the launch counts at
     0 (one MuPS launch a batch, host extraction, routed, B = 256): as many
     points as non-zero pixels, finite normals, the normal image non-zero
     exactly at the projected pixels and unit there; the time split
     (depth->xyz, staging write, serving with patches/s and loader wait,
     projection); then `python -m nestinet_tpu_torch.cli.scan
     --project_to_image 1` end to end on the same scene at 1/4 of the
     resolution (60 x 80) written as a 16-bit PNG, held against
     `predict_scan` on that frame; (b) `cli.synth` against
     `build_protocol_benchmark` file for file, `cli.test_all` over two
     one-shape test lists (its `main` in process, launch counts at 0: one
     MuPS launch a batch) and `cli.evaluate --expert_statistics 1` of its
     results (finite RMS, expert counts equal to the served ids), and the
     MuPS variants (`tdmfv_classification`, `tdmfv_sym`, `fv`, `tdmfv_seg`)
     on the card against the CPU at atol 1e-5;
 16. data parallelism (`train/distributed.py`, `train/mesh.py`) on the one
     card: (a) an NCCL process group of one rank in this process: the
     full-width float32 train step at B = 256 through the data-parallel
     code (the gradient all-reduce) equals the plain step bit for bit
     (weights, buffers, gradients; cuDNN's deterministic algorithms on for
     both), and device-sparse float32 serving of one shape in the group
     writes one process's files of that shape byte for byte; (b) two ranks on cuda:0 over
     gloo with CUDA tensors (NCCL refuses two ranks on one GPU): the B =
     256 step, 128 rows a rank with global BatchNorm moments, against the
     one-process step at phase 13a's bars (the spread measured on the card
     at points moved by 1e-7), the BatchNorm state equal on both ranks, one
     MuPS launch and no plain backward call a rank and a step, the step
     and its gradient all-reduce timed per rank; `cli.train
     --data_parallel 2 --backend gloo` for one epoch of 13c's sets; `cli.test
     --data_parallel 2 --backend gloo` with device extraction in float32
     on two of the test shapes (ids identical to phase 7's, normals within
     1e-4) and in int8 with BatchNorm folded on one (one process's files
     of that shape byte for byte), each rank's patches, expert runs and
     launches counted.  Phase 16 first
     serves that one shape in one process in float32 and int8+fold, the
     references of 16a and 16b: routed, an expert run holds rows of several
     shapes, so a one-shape call's files are not phase 7's or 10's.  Two
     ranks on one card measure the data-parallel path's overhead, not its
     scaling.
 17. expert parallelism (`train/mesh.py`'s (data, expert) mesh and expert
     shards, `models/experts.py`'s expert gather) on the one card: (a) in
     phase 16b's launch, after its steps, the same two gloo ranks form a
     1 x 2 mesh: each builds the full-width float32 model from the seed
     and keeps the manager, 3 of group 0's 6 one-scale experts and the
     three-scale singleton (117,552,877 parameters a rank), and takes the
     B = 256 step on all 256 rows, held against the one-process step at
     phase 13a's bars (the loss, every gradient gathered into the
     one-process layout, the BatchNorm state at atol 1e-5 and equal on both
     ranks where both hold it), one MuPS launch and no plain backward call
     a rank, the step, the expert gather and the gradient all-reduce timed
     and the peak memory read per rank; (b) `cli.train --expert_parallel 2
     --backend gloo` for one epoch on 9 of 13c's 18 training shapes (2
     steps of 256) and 13c's validation set: its checkpoint must hold the
     one-process layout of 13c's run (keys and shapes of the weights, the
     BatchNorm state and Adam's moments), and `cli.test` serves it once
     (device-sparse f32, one shape, launch counts set to 0 before it and
     read after).
 18. the quality bar on the committed trained run dirs
     (`tests/test_torch_quality_fixture.py` writes them with JAX): (a) the
     port's `cli.synth` writes the MoE run dir's protocol sets and
     `scripts/run_quality.py` serves a copy of it in the six modes of its
     `anchor.json` (host-dense f32; device-sparse f32, bf16, bf16+fold,
     int8, int8+fold): each testset's RMS within 0.01 deg of JAX's
     host-dense f32 anchor in host-dense f32 and within 0.1 deg in every
     other mode, and within 0.01 deg of JAX's same mode in every mode; one
     MuPS launch a served batch, the int8 kernel in the int8 modes only, as
     often as their batches and expert runs make; (b) `scripts/switching_demo.py` on the switching run
     dir (its `SW_BACKBONE` narrowed to `TINY`, as JAX wrote it) against
     JAX's committed table: per noise level the small-branch share within
     one patch, the mean noise within 1e-4, the RMS within 0.01 deg; (c)
     the port's EM fits a K = 64 learned GMM to 65,536 of phase 4's served
     points, and both MuPS kernels run on its unequal weights and
     anisotropic sigmas against the plain version at atol 1e-5, the
     blocked one identical to kernel 1.
 19. drawing and HDF5 without matplotlib, PIL or h5py: (a)
     `cli.evaluate --export_visualizations 1 --expert_statistics 1` on
     18a's device-sparse float32 results of `testset`: exactly JAX's file
     set, each PNG decoded by `viz/png.py` to its header's size with
     something drawn; (b) the committed ModelNet HDF5 fixture read through
     `data/modelnet.py` equal to its `expected.npz`; it prints whether the
     three libraries are importable, the files, bytes and seconds, and
     fails past 60 s.

Before phase 16 the whole script ran in about 905 s on an H100 (phases
1-12 about 300 s, phase 14 about 195 s, phase 15 about 250 s, of its
1,200 s limit), and one call on a slower host took 30% longer.  Phase 16
adds about 230 s, so the depth of earlier phases was cut for it, phase
14's first: it serves one test shape where it served two, times 6 steps
where it took 10 and runs 1 epoch of `cli.train` where it ran 2; host
routing serves two shapes where it served six and host-dense one where it
served two; `cli.scan` runs on the scan's scene at 1/4 of the
resolution, held against `predict_scan` on that frame, where it re-served
the whole frame.  Phase 13 keeps its few steps an epoch and cli.test on
two shapes.  The scan's frame served in process is not cut: it is
ScanNet's halved.  Phase 17 adds 63-76 s (its steps about 10 s inside
phase 16b's launch, its cli.train 2 steps on 9 of 13c's 18 training
shapes, its cli.test one shape); with it the script took 937 s on one
H100 host and 1,064 s on a slower one, so the depth of phases 13 and 16
was cut for it: 13c's resumed epoch trains one step (4 of the 18 shapes)
where it took four, and 16b's `cli.test --data_parallel 2` serves two
shapes in float32 and one in int8+fold where it served six in each.
Phase 18 adds about 80 s (81 s on an H100; 52 s before 18d, the quality
drivers at full width) and cuts nothing.  Phase 19 is held under 60 s and cuts
nothing.  Phase 5c adds 20-30 s (20.3 s on an H100) and cuts nothing: the
average pool kernel makes every serving phase's pools faster.

Each serving path and the kernels' entry point run with the launch counts
set to 0 just before and read just after; a kernel of the path that was
not launched fails the run.  The line before the last is the card as
nvidia-smi reports it; the one before that is the kernels' JSON summary;
the last line is {"ok": true, "device": {...}}.  `--record PATH` also
writes every number measured to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 3627473
HOST_BATCH = 128
DEVICE_BATCH = 256
N_POINTS = 5000  # points per synthetic shape; the testset has 6 shapes
N_EXPERTS = 7
BLOCKS = (1, 2, 4, 8)
INT8_BATCH = 256  # the device path's batch
INT8_SUB_BATCH = 37  # a routed expert's sub-batch at B = 256
# a routed run of fewer than B = 256 rows is padded to max(32, B // 4) = 64 rows
INT8_ROUTED_RUN = max(32, INT8_BATCH // 4)
# phase 5 also times the linears and the 2^3 grid's convs at these: a routed
# run and a lone patch
INT8_SMALL_BATCHES = (INT8_ROUTED_RUN, 1)
INT8_COUNTERS = ("int8_conv3d", "int8_gemm")  # the int8 kernels' launch counts
POOL_BATCH_WIDE = 1024  # phase 5b also holds and times the max pool at B = 1024
POOL_TIMED_CALLS = 20  # phase 5b: the calls a timing averages, at least
# phase 5b: (D, H, W), kernel, stride of rows no fixed instance takes, held at B = 37
POOL_ELEMENT_WISE = (((5, 5, 5), 2, 2), ((4, 5, 7), 3, 2), ((6, 6, 6), 3, 1))
# phase 5c: (D, H, W), kernel, stride of average pools no fixed instance takes, at B = 37
AVG_POOL_ELEMENT_WISE = (((5, 5, 5), 3, 1), ((4, 5, 7), 3, 1), ((8, 8, 8), 5, 1),
                         ((3, 3, 3), 4, 1), ((6, 6, 6), 3, 2), ((2, 7, 9), 4, 3))
L2_BYTES = 50 * 2**20  # the H100's L2 cache
KERNEL_ATOL = 1e-5
GRAD_ATOL = 1e-4
NORMALS_ATOL = 1e-4
BF16_ROUTED_RTOL = 0.05  # bfloat16 routed vs dense normals, of max |normal|
# (label, compute_dtype, fold_bn) of the device-sparse dtype paths
DTYPE_PATHS = (("bf16", "bfloat16", False), ("bf16+fold", "bfloat16", True),
               ("int8", "int8", False), ("int8+fold", "int8", True))
EXTRACT_ATOL = 1e-6
# phase 13, training
TRAIN_CHECK_BATCH = 16  # the card's step against the CPU's
TRAIN_BATCHES = (256, 128, 64)  # the step's batch, or the largest that fits
TRAIN_STEPS = {"float32": 10, "bfloat16": 20}  # timed: the median of steps 3-10
TRAIN_LOSS_RTOL = 1e-5
TRAIN_BN_ATOL = 1e-5
# The step's gradients move by up to 5e-3 (relative L2 of a tensor) when the
# CPU's own input points move by 1e-7 relative, about one float32 ulp
# (`scripts/train_step_precision.py`): the card's gradients are held to 4x
# what that perturbation does in the same run, tensor by tensor at the
# worst tensor's spread and over all gradients at the whole spread.
TRAIN_PERTURB_REL = 1e-7
TRAIN_GRAD_SPREADS = 4.0
TRAIN_BIAS_RTOL = 1e-4  # a BN-fed bias's error against its kernel's gradient
TRAIN_PATCHES_PER_SHAPE = 64  # 18 training shapes: 4 steps of 256 an epoch
RESUME_TRAIN_SHAPES = 4  # 13c's resumed epoch: 4 of the 18 shapes, one step
# phase 14, the ablation models
FLAGSHIP_RADII = (0.01, 0.03, 0.05)
ABLATION_RADII = {"ss_norm_est": (1,), "ms_norm_est": (0, 1, 2), "ms_sw_n_est": (0, 2)}
# (label, compute_dtype, fold_bn) served per ablation model
ABLATION_DTYPES = {
    "ss_norm_est": (("f32", "float32", False), ("bf16", "bfloat16", False),
                    ("int8+fold", "int8", True)),
    "ms_norm_est": (("f32", "float32", False), ("bf16", "bfloat16", False)),
    "ms_sw_n_est": (("f32", "float32", False), ("bf16", "bfloat16", False)),
}
# labels of ABLATION_DTYPES also served dense (moe_inference="dense", JAX's path)
# beside their routed run: the switching model's bfloat16
ABLATION_DENSE = {"ms_sw_n_est": "bf16"}
ABLATION_TRAIN_STEPS = 6  # phase 14b: the f32 step timed over steps 3-6
ABLATION_EPOCHS = 1  # phase 14b: cli.train of each ablation model
# phase 14b's test lists of the trained runs: one shape; the switching model's two
# of its own set (the noise levels 0 and 0.03); phase 14a serves testset_one
ABLATION_TESTSET = {"ss_norm_est": "testset_one", "ms_norm_est": "testset_one",
                    "ms_sw_n_est": "testset_two"}
SWITCH_POINTS = 2000  # points per shape of the switching benchmark
# routes of the ablation models served routed (the default): the switching model's branches
ROUTED_BRANCHES = {"ms_sw_n_est": 2}
# max pool launches of one call outside autograd: two pools a CNN, the switching
# model's three CNNs in its dense forward, its gate and a branch one CNN each
ABLATION_POOLS = {"ss_norm_est": {"forward": 2}, "ms_norm_est": {"forward": 2},
                  "ms_sw_n_est": {"forward": 6, "gate": 2, "branch": 2}}
# 30 training and 10 validation shapes: 3 steps of 256 an epoch, 1 validation batch
SWITCH_PATCHES_PER_SHAPE = 32
SWITCH_GAP = 1e-5  # noise estimates this close to 0.015 may take either branch
# phase 15, the scan and the CLIs
SCAN_H, SCAN_W = 240, 320  # ScanNet's 480 x 640 depth frame halved
SCAN_F = 577.870605 / 2  # ScanNet's depth focal length (pixels), halved
SCAN_CLI_DIV = 4  # cli.scan's frame: 15a's scaled by 1/4 (60 x 80), ScanNet's by 1/8
SYNTH_POINTS = 1000  # points per shape of cli.synth's set
# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# Instruction rates of one H100 SXM, per pipe: 132 SMs at 1.98 GHz times the
# instructions an SM completes a clock (the CUDA programming guide's table)
SM_CLOCKS_PER_S = 132 * 1.98e9
FP32_INSTR_PER_S = 128 * SM_CLOCKS_PER_S  # 33.5e12
MUFU_INSTR_PER_S = 16 * SM_CLOCKS_PER_S  # 4.2e12: exp2, reciprocal, rsqrt
FP64_INSTR_PER_S = 64 * SM_CLOCKS_PER_S  # 16.7e12
# The least work of one real (point, Gaussian) pair of the MuPS statistics:
# float32 instructions of one evaluation (3 subtracts; 3 shared-divisor
# divisions, a multiply and 2 FMAs each; |s|^2, 3 multiplies and 2 adds;
# the pdf, 3 multiplies; q, one more division; d_pi, a subtract and a
# multiply; the 6 products q s and q (s^2 - 1) and their 3 subtracts; 13
# max/min), one exponential and 8 float64 sums (the denominator, d_pi's and
# the six of q s and q (s^2 - 1))
MUPS_FP32_PER_PAIR = 3 + 3 * 3 + 5 + 3 + 3 + 2 + 9 + 13  # 47
MUPS_MUFU_PER_PAIR = 1
MUPS_FP64_PER_PAIR = 8


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def flagship_rows(gen, R, N, mode, device):
    """Random points in [-1, 1]^3 with n_eff per `mode`; rows past n_eff are
    zero, as the loader pads them."""
    import torch

    pts = torch.rand((R, N, 3), generator=gen) * 2 - 1
    if mode == "unpadded":
        n_eff = torch.full((R,), N, dtype=torch.int32)
    else:
        n_eff = torch.randint(0, N, (R,), generator=gen, dtype=torch.int32)
        if mode == "zeros":
            n_eff[::3] = 0
    rows = torch.arange(N)[None, :]
    pts[rows > n_eff[:, None].long()] = 0.0
    return pts.to(device), n_eff.to(device)


def randomize_bn(model, gen):
    """Non-trivial BatchNorm state: bias in (0.1, 0.9), debiased mean
    N(0, 0.1), debiased variance U(0.5, 1.5), gamma U(0.8, 1.2)."""
    import torch

    from nestinet_tpu_torch.ops.nn import BatchNormEMA

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNormEMA):
                c = m.ema_mean.shape[0]
                keep = 1.0 - (0.1 + 0.8 * torch.rand((), generator=gen))
                m.bias.fill_(1.0 - keep)
                m.ema_mean.copy_(torch.randn(c, generator=gen) * 0.1 * keep)
                m.ema_var.copy_((0.5 + torch.rand(c, generator=gen)) * keep)
                m.gamma.copy_(0.8 + 0.4 * torch.rand(c, generator=gen))


def spread_manager_logits(model, grids, queries, radii, seed, caps):
    """Rescale the manager's last layer so that its logits on one batch of
    real patches are about 1 + 2 N(0, 1) per expert: with random weights
    most of them otherwise sit below the final ReLU, and nearly every patch
    routes to one expert."""
    import torch

    from nestinet_tpu_torch.infer.device_pipeline import extract_batch

    head = model.manager.head
    with torch.inference_mode():
        points, n_eff = extract_batch(grids, queries, radii, seed,
                                      num_point=model.cfg.num_point, caps=caps)
        x = model.mups_grid(points, n_eff).permute(0, 4, 1, 2, 3)
        h = head.fc3(head.fc2(head.fc1(model.manager.backbone(x))))
        last = head.fc4.linear
        z = h @ last.w.t()  # [B, E], before the bias
        scale = 2.0 / z.std(dim=0)
        last.w.mul_(scale[:, None])
        last.b.copy_(1.0 - z.mean(dim=0) * scale)


def check_kernel(gen, dev, gmm_t, R, N=512):
    """Phase 3 at R rows: the MuPS kernel against its plain version."""
    import torch

    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.kernels import mups_cuda

    max_err = 0.0
    for mode in ("unpadded", "random", "zeros"):
        pts, n_eff = flagship_rows(gen, R, N, mode, dev)
        got = mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, n_eff)
        want = mups_ops.tdmfv_n_est_reference(pts, *gmm_t, n_eff)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"kernel output not finite ({mode}, R={R})")
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        print(f"kernel vs plain [R={R}, {mode}]: max abs err {err:.3e} (atol {KERNEL_ATOL})",
              flush=True)
        if not err <= KERNEL_ATOL:  # NaN fails too
            fail(f"MuPS kernel disagrees with its plain version ({mode}, R={R}): {err}")
    return max_err


def check_gradient(gen, dev):
    """Phase 3: the gradient through the autograd.Function at a small
    shape; unpadded, because a statistic that is exactly 0 (a masked row's
    zero deciding a max) has no derivative under the signed square root, in
    the reference as here."""
    import torch

    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    gmm3 = get_3d_grid_gmm([3, 3, 3], variance=1.0 / 9)
    w3, mu3, s3 = (torch.from_numpy(a).to(dev) for a in gmm3.astuple())
    pts, n_eff = flagship_rows(gen, 8, 64, "unpadded", dev)
    weights = torch.arange(20.0, device=dev)[None, :, None]
    p1 = pts.clone().requires_grad_(True)
    (mups_ops.tdmfv_n_est(p1, w3, mu3, s3, n_eff) ** 2 * weights).sum().backward()
    p2 = pts.clone().requires_grad_(True)
    (mups_ops.tdmfv_n_est_reference(p2, w3, mu3, s3, n_eff) ** 2 * weights).sum().backward()
    torch.cuda.synchronize()
    gerr = (p1.grad - p2.grad).abs().max().item()
    print(f"kernel gradient vs plain: max abs err {gerr:.3e} (atol {GRAD_ATOL})", flush=True)
    if not gerr <= GRAD_ATOL:
        fail(f"gradient through the kernel's Function disagrees: {gerr}")


def check_wide(gen, dev, R=256, N=512, m=10):
    """Phase 3 with m^3 > 512 Gaussians, the kernels' 1024-thread instance:
    kernel 1 and the blocked kernel at every block_b against the plain
    version (atol 1e-5), the blocked one identical to kernel 1; returns the
    largest error."""
    import torch

    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
    from nestinet_tpu_torch.ops.kernels import mups_cuda

    gmm_t = tuple(torch.from_numpy(a).to(dev)
                  for a in get_3d_grid_gmm([m, m, m], variance=1.0 / m ** 2).astuple())
    pts, n_eff = flagship_rows(gen, R, N, "zeros", dev)
    want = mups_ops.tdmfv_n_est_reference(pts, *gmm_t, n_eff)
    one = mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, n_eff)
    torch.cuda.synchronize()
    err = (one - want).abs().max().item()
    if not (torch.isfinite(one).all() and err <= KERNEL_ATOL):
        fail(f"MuPS kernel disagrees with its plain version at K={m ** 3}: {err}")
    for bb in BLOCKS:
        got = mups_cuda.tdmfv_n_est_blocked_cuda(pts, *gmm_t, n_eff, bb)
        torch.cuda.synchronize()
        if not torch.equal(got, one):
            fail(f"blocked kernel differs from the one-row kernel at K={m ** 3} (block_b={bb})")
    print(f"kernel vs plain [R={R}, K={m ** 3}, random and n_eff = 0 rows]: max abs err "
          f"{err:.3e} (atol {KERNEL_ATOL}); blocked kernel identical at block_b {BLOCKS}",
          flush=True)
    return err


def check_blocked(gen, dev, gmm_t, R=3 * DEVICE_BATCH, N=512):
    """Phase 4: the blocked kernel against the plain version and against
    the one-row-per-block kernel; (max err to plain, max diff to kernel 1)."""
    import torch

    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.kernels import mups_cuda

    max_err = max_diff = 0.0
    for mode in ("unpadded", "random", "zeros"):
        pts, n_eff = flagship_rows(gen, R, N, mode, dev)
        want = mups_ops.tdmfv_n_est_reference(pts, *gmm_t, n_eff)
        one = mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, n_eff)
        for bb in BLOCKS:
            got = mups_cuda.tdmfv_n_est_blocked_cuda(pts, *gmm_t, n_eff, bb)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"blocked kernel output not finite ({mode}, block_b={bb})")
            err = (got - want).abs().max().item()
            diff = (got - one).abs().max().item()
            max_err, max_diff = max(max_err, err), max(max_diff, diff)
            print(f"blocked kernel [block_b={bb}, {mode}]: max abs err {err:.3e} "
                  f"(atol {KERNEL_ATOL}), max abs diff from the one-row kernel {diff:.3e}",
                  flush=True)
            if not err <= KERNEL_ATOL:
                fail(f"blocked kernel disagrees with its plain version ({mode}, "
                     f"block_b={bb}): {err}")
            if not diff == 0.0:
                fail(f"blocked kernel differs from the one-row kernel ({mode}, "
                     f"block_b={bb}): {diff}")
    pts, n_eff = flagship_rows(gen, R - 2, N, "random", dev)
    try:
        mups_cuda.tdmfv_n_est_blocked_cuda(pts, *gmm_t, n_eff, 4)
    except ValueError as e:
        print(f"blocked kernel, {R - 2} rows in blocks of 4: raises ({e})", flush=True)
    else:
        fail(f"blocked kernel took {R - 2} rows in blocks of 4")
    return max_err, max_diff


def backbone_convs(nets) -> list:
    """Every distinct (cin, cout, k, r) conv of the backbones `nets`
    [(layer table, input channels)] on the 8^3 grid."""
    convs = []
    for spec, c in nets:
        r = 8
        for entry in spec:
            if entry[0] == "maxpool":
                r = -(-r // entry[2])
                continue
            _, n, (k1, k2) = entry
            for shape in ((c, n, 1, r), (n, n // 2, k1, r), (n, n // 2, k2, r)):
                if shape not in convs:
                    convs.append(shape)
            c = n + 2 * (n // 2) + n
    return convs


def fc_layers(*heads) -> list:
    """The distinct (cin, cout) of the FC heads' layers, each head its widths."""
    return list(dict.fromkeys((a, b) for widths in heads for a, b in zip(widths, widths[1:])))


def switching_layer_shapes():
    """The switching model's int8 layers: the convs of `SW_BACKBONE` on one
    radius's 20 channels (its three CNNs share it), and the (cin, cout) of
    the noise head (FC 1024/256/128/1) and the normal heads (1024/256/128/3)
    on the 2^3 grid's 1536 channels."""
    from nestinet_tpu_torch.models import backbones

    return (backbone_convs([(backbones.SW_BACKBONE, 20)]),
            fc_layers((8 * 1536, 1024, 256, 128, 1), (8 * 1536, 1024, 256, 128, 3)))


def int8_layer_shapes():
    """Every distinct (cin, cout, k, r) conv of the flagship manager, of
    both expert widths (first width 128 on 20 channels, 42 on 60) and of the
    switching model (`switching_layer_shapes`), and the (cin, cout) of their
    FC layers."""
    from nestinet_tpu_torch.models import backbones

    sw_convs, sw_fcs = switching_layer_shapes()
    convs = backbone_convs([(backbones.CONV_NET_8G, 60), (backbones.expert_backbone_8g(128), 20),
                            (backbones.expert_backbone_8g(42), 60)])
    fcs = fc_layers((1536, 1024, 256, 128, N_EXPERTS), (1536, 512, 128, 64, 3))
    return (list(dict.fromkeys(convs + sw_convs)), list(dict.fromkeys(fcs + sw_fcs)))


def bound(ops: float, nbytes: float, ops_per_s: float):
    """(least ms, "operations" or "bytes"): the larger of the work over the
    card's peak rate for its type and the bytes over its memory rate."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mups_bound(n_eff, N: int, K: int):
    """The MuPS kernels' bound for these rows: the least time of each pipe
    for one evaluation of every real (point, Gaussian) pair
    (MUPS_*_PER_PAIR at the H100's instruction rates: FP32 128, MUFU 16,
    FP64 64 a clock per SM), the largest of the three, or the bytes (the
    points, n_eff, the Gaussians' 8 K floats, the [20, K] output rows) at
    3.35 TB/s if those take longer.  Rows past n_eff are never evaluated.
    (ms, "operations" or "bytes")."""
    rows = n_eff.numel()
    pairs = float((n_eff.clamp(min=-1, max=N - 1) + 1).sum().item()) * K
    ms = max(pairs * MUPS_FP32_PER_PAIR / FP32_INSTR_PER_S,
             pairs * MUPS_MUFU_PER_PAIR / MUFU_INSTR_PER_S,
             pairs * MUPS_FP64_PER_PAIR / FP64_INSTR_PER_S) * 1e3
    t_bytes = (rows * (3 * N * 4 + 4) + 8 * K * 4 + rows * 20 * K * 4) / HBM_BYTES_PER_S * 1e3
    return (ms, "operations") if ms >= t_bytes else (t_bytes, "bytes")


def check_served_rows(dev, gmm_t, card):
    """Phase 4 on served rows: both MuPS kernels against the plain version
    on the 768 rows of one batch extracted on the card at PCPNet's density
    (atol 1e-5), the blocked kernel identical to kernel 1 at every block_b;
    each timed there.  Returns the numbers."""
    import torch

    from nestinet_tpu_torch.core.device import cuda_median_ms
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.kernels import mups_cuda
    from nestinet_tpu_torch.scripts.mups_kernel_parts import served_rows

    with torch.inference_mode():
        pts, ne = served_rows(dev, SEED)
    N = pts.shape[1]
    by_radius = ne.reshape(-1, 3).float().mean(0).tolist()
    print("served rows: n_eff mean by radius " + ", ".join(f"{v:.1f}" for v in by_radius),
          flush=True)
    want = mups_ops.tdmfv_n_est_reference(pts, *gmm_t, ne)
    one = mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, ne)
    torch.cuda.synchronize()
    err = (one - want).abs().max().item()
    print(f"kernel vs plain [served rows, R={pts.shape[0]}, n_eff min {int(ne.min())} mean "
          f"{float(ne.float().mean()):.1f} max {int(ne.max())}]: max abs err {err:.3e} "
          f"(atol {KERNEL_ATOL})", flush=True)
    if not (torch.isfinite(one).all() and err <= KERNEL_ATOL):
        fail(f"MuPS kernel disagrees with its plain version on served rows: {err}")
    blocked_err = 0.0
    for bb in BLOCKS:
        got = mups_cuda.tdmfv_n_est_blocked_cuda(pts, *gmm_t, ne, bb)
        torch.cuda.synchronize()
        blocked_err = max(blocked_err, (got - want).abs().max().item())
        if not torch.equal(got, one):
            fail(f"blocked kernel differs from the one-row kernel on served rows "
                 f"(block_b={bb})")
    print(f"blocked kernel [served rows, block_b {BLOCKS}]: identical to the one-row kernel",
          flush=True)
    ms = cuda_median_ms(lambda: mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, ne))
    blocked = {bb: cuda_median_ms(lambda bb=bb: mups_cuda.tdmfv_n_est_blocked_cuda(
        pts, *gmm_t, ne, bb)) for bb in BLOCKS}
    plain = cuda_median_ms(lambda: mups_ops.tdmfv_n_est_reference(pts, *gmm_t, ne),
                           warmup=2, iters=10)
    bound_ms = mups_bound(ne, N, gmm_t[0].numel())
    print(f"time: MuPS kernel {ms:.4f} ms, blocked " + ", ".join(
        f"block_b={bb} {t:.4f} ms" for bb, t in blocked.items()) + f", plain {plain:.4f} ms per "
        f"{pts.shape[0]} served rows; bound {bound_ms[0]:.4f} ms ({bound_ms[1]}) [{card}]",
        flush=True)
    return {"max_abs_err": err, "blocked_max_abs_err": blocked_err, "ms": ms,
            "blocked_ms": blocked, "plain_ms": plain, "bound": bound_ms,
            "n_eff_mean": float(ne.float().mean()), "n_eff_mean_by_radius": by_radius}


def int8_case(gen, dev, B, cin, cout, k, r):
    """Operands of the fused int8 kernel: a bfloat16 activation N(0, 2^2)
    [B, cin, r, r, r], int8 weights in [-127, 127] packed [cout, k^3,
    cin_p] with zeros in the padding, positive scales, a random bias, and a
    forwarded bound 1.25 max|x| (as an average pool keeps one above max|x|)."""
    import torch

    from nestinet_tpu_torch.ops.quant import padded_channels

    cin_p = padded_channels(cin)
    x = (torch.randn((B, cin, r, r, r), generator=gen) * 2).to(torch.bfloat16)
    w_q = torch.zeros((cout, k ** 3, cin_p), dtype=torch.int8)
    w_q[..., :cin] = torch.randint(-127, 128, (cout, k ** 3, cin), generator=gen,
                                   dtype=torch.int8)
    s_w = (torch.rand(cout, generator=gen) + 0.5) * 1e-3
    b = torch.randn(cout, generator=gen)
    x_amax = x.abs().amax().float() * 1.25
    return tuple(t.to(dev) for t in (x, w_q, s_w, b, x_amax))


def int_mm_ms(args, B, r):
    """`torch._int_mm` on the int8 operands of a 1x1x1 conv or an FC (the
    quantized activation channels-last [M, cin_p] times w_q^T): the int32
    product alone, as one library call; None where it refuses the shape."""
    import torch

    from nestinet_tpu_torch.core.device import cuda_median_ms
    from nestinet_tpu_torch.ops import quant

    x, w_q, _, _, x_amax = args
    a = quant.quantize_activation(x, quant.activation_scale(x, x_amax))
    a = a.reshape(B * r ** 3, -1)
    w = w_q[:, 0, :].t()
    try:
        torch._int_mm(a, w)
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return cuda_median_ms(lambda: torch._int_mm(a, w), warmup=2, iters=10)


def check_int8_kernel(gen, dev, card):
    """Phase 5: the int8 kernels against their plain version at every conv
    and FC shape of the flagship, both expert widths and the switching
    model, at B = 256 and 37 (the FCs and the 2^3 grid's convs also at
    B = 64 and 1, the switching model's layers also at B = 64, the router's
    padded run), ReLU off and on,
    each with the forwarded bound and with the scale from max|x|: outputs
    and max|out| identical, and each call launched the kernel `kernel_for`
    names (the GEMM at k = 1, the conv kernels above) and no other.  Each
    shape timed (CUDA events) beside its bound and, at k = 1, `torch._int_mm`
    on the int8 operands.  Returns (max abs err, per-shape rows, the widest
    conv's and the widest k = 1 layer's rows with the plain version's time)."""
    import torch

    from nestinet_tpu_torch.core.device import cuda_median_ms
    from nestinet_tpu_torch.ops import quant
    from nestinet_tpu_torch.ops.kernels import int8_cuda

    t5 = time.perf_counter()
    convs, fcs = int8_layer_shapes()
    cases = [(B, cin, cout, k, r) for B in (INT8_BATCH, INT8_SUB_BATCH)
             for cin, cout, k, r in convs]
    cases += [(B, cin, cout, k, r) for B in INT8_SMALL_BATCHES
              for cin, cout, k, r in convs if r == 2]
    cases += [(B, cin, cout, 1, 1) for B in (INT8_BATCH, INT8_SUB_BATCH, *INT8_SMALL_BATCHES)
              for cin, cout in fcs]
    sw_convs, sw_fcs = switching_layer_shapes()
    cases += [(INT8_ROUTED_RUN, cin, cout, k, r) for cin, cout, k, r in sw_convs]
    cases += [(INT8_ROUTED_RUN, cin, cout, 1, 1) for cin, cout in sw_fcs]
    cases = list(dict.fromkeys(cases))
    sms = int8_cuda.sm_count(dev.index)
    max_err, rows = 0.0, []
    for B, cin, cout, k, r in cases:
        args = int8_case(gen, dev, B, cin, cout, k, r)
        x, w_q, s_w, b, x_amax = args
        cin_p, M = w_q.shape[-1], B * r ** 3
        bm, bn = int8_cuda.tile_shape(M, cout, sms)
        which = int8_cuda.kernel_for(cin, r, r, r, cin_p, k, bm, bn)
        counter = "int8_gemm" if which == "gemm" else "int8_conv3d"
        if k == 1 and which != "gemm":
            fail(f"the 1x1x1 conv or linear {(B, cin, cout, k, r)} would run the {which} kernel")
        for relu, bound_in in itertools.product((False, True), (x_amax, None)):
            for kk in int8_cuda.KERNELS:
                kk.reset_launches()
            got, got_amax = quant.int8_conv3d_fused(x, w_q, s_w, b, k, bound_in, relu=relu,
                                                    want_amax=True)
            launches = {n: c for kk in int8_cuda.KERNELS for n, c in kk.launches.items()}
            want, want_amax = quant.int8_conv3d_fused_reference(x, w_q, s_w, b, k, bound_in,
                                                                relu=relu, want_amax=True)
            torch.cuda.synchronize()
            if launches != {n: int(n == counter) for n in INT8_COUNTERS}:
                fail(f"int8 {(B, cin, cout, k, r)} ({which}) launched {launches}")
            if got.dtype != torch.bfloat16 or got.shape != (B, cout, r, r, r):
                fail(f"int8 kernel output {got.dtype} {tuple(got.shape)} at "
                     f"{(B, cin, cout, k, r)}")
            n_diff = int((got != want).sum())
            err = (got.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            if n_diff or not torch.equal(got_amax, want_amax):
                fail(f"int8 kernel ({which}) differs from its plain version at "
                     f"{(B, cin, cout, k, r)}, relu={relu}, bound "
                     f"{'forwarded' if bound_in is not None else 'max|x|'}: {n_diff} outputs, "
                     f"amax {got_amax.item()} vs {want_amax.item()}")
        ms = cuda_median_ms(lambda: int8_cuda.int8_conv3d_cuda(
            x, w_q, s_w, b, k, x_amax, relu=True, want_amax=True), warmup=2, iters=10)
        ops = 2.0 * B * r ** 3 * cout * k ** 3 * cin
        nbytes = B * r ** 3 * (cin + cout) * 2 + w_q.numel() + cout * 8 + 8
        bound_ms, bound_by = bound(ops, nbytes, INT8_OPS_PER_S)
        lib_ms = int_mm_ms(args, B, r) if k == 1 else None
        if which == "gemm":
            bn, splits = int8_cuda.gemm_plan(M, cout, cin_p, sms)
            bm = int8_cuda.GEMM_BM
        else:
            splits = 1
        rows.append({"B": B, "cin": cin, "cout": cout, "k": k, "r": r, "kernel": which,
                     "tile": [bm, bn], "cluster": splits, "ms": ms, "tops": ops / ms / 1e9,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        lib = "" if lib_ms is None else f", torch._int_mm {lib_ms:.4f} ms"
        print(f"int8 {which} kernel [B={B}, cin={cin}, cout={cout}, k={k}, r={r}, tile "
              f"{bm}x{bn}, cluster {splits}]: identical to the plain version (ReLU off and on, "
              f"forwarded bound and max|x|, max|out| too), launched it alone; {ms:.4f} ms, "
              f"{ops / ms / 1e9:.1f} TOPS, bound {bound_ms:.4f} ms ({bound_by}){lib}",
              flush=True)

    def widest(of):
        return dict(max(of, key=lambda t: t["B"] * t["r"] ** 3 * t["cout"] * t["k"] ** 3
                        * t["cin"]))

    picks = {"conv": widest([t for t in rows if t["k"] > 1]),
             "gemm": widest([t for t in rows if t["k"] == 1])}
    for kind, w in picks.items():
        k = w["k"]
        args = int8_case(gen, dev, w["B"], w["cin"], w["cout"], k, w["r"])
        w["ms"] = cuda_median_ms(lambda: int8_cuda.int8_conv3d_cuda(
            *args[:4], k, args[4], relu=True, want_amax=True))
        w["plain_ms"] = cuda_median_ms(lambda: quant.int8_conv3d_fused_reference(
            *args[:4], k, args[4], relu=True, want_amax=True), warmup=1, iters=3)
        w["tops"] = 2.0 * w["B"] * w["r"] ** 3 * w["cout"] * k ** 3 * w["cin"] / w["ms"] / 1e9
        print(f"time: int8 {w['kernel']} kernel {w['ms']:.4f} ms ({w['tops']:.1f} int8 TOPS, "
              f"{100 * w['bound_ms'] / w['ms']:.1f}% of its bound {w['bound_ms']:.4f} ms, "
              f"{w['bound_by']}), plain {w['plain_ms']:.4f} ms at the widest "
              f"{'conv' if kind == 'conv' else 'k = 1 layer'} [B={w['B']}, cin={w['cin']}, "
              f"cout={w['cout']}, k={k}, r={w['r']}] [{card}]", flush=True)
    print(f"phase 5: {len(cases)} shapes, the phase took {time.perf_counter() - t5:.1f} s",
          flush=True)
    return max_err, rows, picks


def served_pools() -> list:
    """(C, R, k, s) of the input of every max pool of `served_nets`."""
    from nestinet_tpu_torch.models import backbones as bb

    return sorted({p for spec, r in served_nets() for p in bb.pool_inputs(spec, 60, r)})


def served_nets() -> list:
    """(spec, resolution) of the served backbones (the manager, both expert
    widths, SW = MS = SS), of CONV_NET_3G and of TINY on both grids."""
    from nestinet_tpu_torch.models import backbones as bb

    return [(bb.CONV_NET_8G, 8), (bb.expert_backbone_8g(128 // 3), 8),
            (bb.expert_backbone_8g(128), 8), (bb.SW_BACKBONE, 8), (bb.MS_BACKBONE_8G, 8),
            (bb.SS_BACKBONE, 8), (bb.CONV_NET_3G, 3), (bb.TINY, 8), (bb.TINY, 3)]


def served_avg_pools() -> list:
    """(C, R, k) of the input of every Inception block's average pool of the
    nets of `served_nets`, at inference (stride 1), on the 60 channels of
    three radii and the 20 of one (a one-scale expert, the switching CNNs)."""
    from nestinet_tpu_torch.models import backbones as bb

    return sorted({p for spec, r in served_nets() for cin in (20, 60)
                   for p in bb.avg_pool_inputs(spec, cin, r)})


def planted_on_card(gen, dev, shape, dtype):
    """Normal values in `dtype` on the card, about 2% each of two NaNs (the
    canonical quiet NaN and all bits set), 4% each -inf, +0 and -0, and some
    whole rows of zeros of both signs and of -inf."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev)
    pick = torch.rand(shape, generator=gen, device=dev)
    neg_zero = torch.full((), -0.0, device=dev)
    x = torch.where((pick >= 0.04) & (pick < 0.08), float("-inf"), x)
    x = torch.where((pick >= 0.08) & (pick < 0.12), 0.0, x)
    x = torch.where((pick >= 0.12) & (pick < 0.16), neg_zero, x)
    which = torch.rand(shape[:-1] + (1,), generator=gen, device=dev)
    signs = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, 0.0, neg_zero)
    x = torch.where(which < 0.05, signs, torch.where(which < 0.08, float("-inf"), x))
    x = x.to(dtype)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    bits = x.view(ints)
    bits[pick < 0.02] = torch.tensor(float("nan"), dtype=dtype).view(ints).item()
    bits[(pick >= 0.02) & (pick < 0.04)] = -1
    return x


def device_ms(calls, attempts: int = 3) -> tuple:
    """(device ms, device launches) a call of the calls in `calls`, each run
    once after one warm-up round, from torch.profiler's device activity; a
    profile that recorded no device time (CUPTI drops one now and then) is
    taken again, up to `attempts` profiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        if events:
            return (sum(e.self_device_time_total for e in events) / 1e3 / len(calls),
                    sum(e.count for e in events) / len(calls))
    fail(f"torch.profiler recorded no device time in {attempts} profiles")


def check_max_pool(dev, card):
    """Phase 5b: the max pool kernel against aten's `F.max_pool3d` on the
    card (`ops/nn.py::max_pool3d_reference`) at every served pool shape
    (`served_pools`) at B = 256, 37, 64 (the router's padded run) and 1024,
    and at the shapes of `POOL_ELEMENT_WISE` at B = 37, in bfloat16 and
    float32, NaN (two payloads), -inf and signed zeros planted: bits
    identical, one launch a call.  At B = 256 and 1024 in
    bfloat16 each shape is timed on the device (`device_ms`, over copies of
    the input that together exceed the L2 cache twice, so that each call
    reads from device memory) beside its byte bound, the plain version (the
    -inf pad copy and aten's pool) and aten's pool alone (`library_ms`, on
    the padded input), with the launches a call of each.  Returns the
    timing rows."""
    import torch
    import torch.nn.functional as F

    from nestinet_tpu_torch.ops import nn as tnn
    from nestinet_tpu_torch.ops.kernels import pool_cuda

    t5 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pools = served_pools()
    cases = [(B, C, (R,) * 3, k, s) for (C, R, k, s), B in itertools.product(
        pools, (INT8_BATCH, INT8_SUB_BATCH, INT8_ROUTED_RUN, POOL_BATCH_WIDE))]
    cases += [(INT8_SUB_BATCH, 24, size, k, s) for size, k, s in POOL_ELEMENT_WISE]
    rows, n_cases = [], 0
    for (B, C, size, k, s), dtype in itertools.product(cases, (torch.bfloat16, torch.float32)):
        x = planted_on_card(gen, dev, (B, C, *size), dtype)
        ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
        pool_cuda.POOL.reset_launches()
        got = pool_cuda.max_pool3d_cuda(x, k, s)
        launches = pool_cuda.POOL.launches["max_pool3d"]
        want = tnn.max_pool3d_reference(x, k, s)
        torch.cuda.synchronize()
        n_cases += 1
        if launches != 1:
            fail(f"max pool {(B, C, size, k, s)} {dtype}: {launches} launches")
        if got.shape != want.shape:
            fail(f"max pool {(B, C, size, k, s)}: shape {tuple(got.shape)}, aten's "
                 f"{tuple(want.shape)}")
        n_diff = int((got.view(ints) != want.view(ints)).sum())
        if n_diff:
            fail(f"max pool {(B, C, size, k, s)} {dtype}: {n_diff} outputs differ from aten's "
                 f"bits")
        R = size[0]
        if (dtype != torch.bfloat16 or B not in (INT8_BATCH, POOL_BATCH_WIDE)
                or not pool_cuda.fixed_row(size[-1], k, s)):
            continue
        nbytes = (x.numel() + got.numel()) * x.element_size()
        copies = [x] + [x.clone() for _ in range(-(-2 * L2_BYTES // nbytes) - 1)]
        padded = [tnn._pad_same(c, k, s, value=float("-inf")) for c in copies]
        rounds = -(-POOL_TIMED_CALLS // len(copies))
        ms, n = device_ms([lambda c=c: pool_cuda.max_pool3d_cuda(c, k, s)
                           for c in copies] * rounds)
        plain_ms, plain_n = device_ms([lambda c=c: tnn.max_pool3d_reference(c, k, s)
                                       for c in copies] * rounds)
        lib_ms, lib_n = device_ms([lambda c=c: F.max_pool3d(c, k, s) for c in padded] * rounds)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"B": B, "C": C, "R": R, "k": k, "s": s, "ms": ms, "launches": n,
                     "bound_ms": bound_ms, "bound_pct": 100 * bound_ms / ms, "bytes": nbytes,
                     "plain_ms": plain_ms, "plain_launches": plain_n, "library_ms": lib_ms,
                     "library_launches": lib_n})
        print(f"time: max pool [B={B}, C={C}, {R}^3, k={k}, s={s}, bf16]: {ms:.4f} ms of "
              f"device time in {n:g} launch, {100 * bound_ms / ms:.1f}% of its byte bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes); plain {plain_ms:.4f} ms in {plain_n:g} "
              f"launches, F.max_pool3d {lib_ms:.4f} ms in {lib_n:g} launches [{card}]", flush=True)
        del copies, padded
    print(f"phase 5b: the max pool identical to aten's at {n_cases} cases ({len(pools)} served "
          f"shapes at 4 batches and {len(POOL_ELEMENT_WISE)} of the element-wise kernel, 2 "
          f"dtypes), one launch each; the phase took {time.perf_counter() - t5:.1f} s",
          flush=True)
    return rows


def planted_avg_on_card(gen, dev, shape, dtype):
    """Normal values in `dtype` on the card, about 0.2% each of two NaNs (the
    canonical quiet NaN and all bits set), +inf and -inf, 4% each +0 and -0;
    whole (sample, channel) volumes of -0, of zeros of both signs, of values
    near the largest finite float32 (their sums overflow) and of subnormals."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev) * 3
    pick = torch.rand(shape, generator=gen, device=dev)
    neg_zero = torch.full((), -0.0, device=dev)
    x = torch.where((pick >= 0.004) & (pick < 0.006), float("inf"), x)
    x = torch.where((pick >= 0.006) & (pick < 0.008), float("-inf"), x)
    x = torch.where((pick >= 0.008) & (pick < 0.048), 0.0, x)
    x = torch.where((pick >= 0.048) & (pick < 0.088), neg_zero, x)
    which = torch.rand(shape[:2] + (1, 1, 1), generator=gen, device=dev)
    signs = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.5, 0.0, neg_zero)
    x = torch.where(which < 0.04, neg_zero, torch.where(which < 0.07, signs, x))
    x = torch.where((which >= 0.07) & (which < 0.09), x * 1e38, x)
    x = torch.where((which >= 0.09) & (which < 0.11), x * 1e-39, x)
    x = x.to(dtype)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    bits = x.view(ints)
    bits[pick < 0.002] = torch.tensor(float("nan"), dtype=dtype).view(ints).item()
    bits[(pick >= 0.002) & (pick < 0.004)] = -1
    return x


def check_avg_pool(dev, card):
    """Phase 5c: the average pool kernel against its plain version on the
    card (`ops/nn.py::avg_pool3d_reference`: aten's pad, adds, divisor and
    divide, then aten's ReLU) at every served average pool shape
    (`served_avg_pools`) at B = 256 and 1024, and at the shapes of
    `AVG_POOL_ELEMENT_WISE` at B = 37, in bfloat16 and float32, with and
    without the ReLU, NaN (two payloads), +-inf, signed zeros, overflowing
    and subnormal volumes planted: bits identical, one launch a call.  At
    B = 256 and 1024 in bfloat16 each served shape is timed on the device
    (`device_ms`, over copies of the input that together exceed the L2 cache
    twice) beside its byte bound and the plain version, with the launches a
    call of each.  Returns the timing rows and aten's ReLU of -0 on the card."""
    import torch

    from nestinet_tpu_torch.ops import nn as tnn
    from nestinet_tpu_torch.ops.kernels import pool_cuda

    t5 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pools = served_avg_pools()
    cases = [(B, C, (R,) * 3, k, 1) for (C, R, k), B in itertools.product(
        pools, (INT8_BATCH, POOL_BATCH_WIDE))]
    cases += [(INT8_SUB_BATCH, 24, size, k, s) for size, k, s in AVG_POOL_ELEMENT_WISE]
    rows, n_cases = [], 0
    for (B, C, size, k, s), dtype in itertools.product(cases, (torch.bfloat16, torch.float32)):
        x = planted_avg_on_card(gen, dev, (B, C, *size), dtype)
        ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
        for relu in (False, True):
            pool_cuda.AVG_POOL.reset_launches()
            got = pool_cuda.avg_pool3d_cuda(x, k, s, relu)
            launches = pool_cuda.AVG_POOL.launches["avg_pool3d"]
            want = tnn.avg_pool3d_reference(x, k, s, relu)
            torch.cuda.synchronize()
            n_cases += 1
            name = f"average pool {(B, C, size, k, s)} {dtype} relu={relu}"
            if launches != 1:
                fail(f"{name}: {launches} launches")
            if got.shape != want.shape:
                fail(f"{name}: shape {tuple(got.shape)}, the plain version's {tuple(want.shape)}")
            n_diff = int((got.view(ints) != want.view(ints)).sum())
            if n_diff:
                n_nan = int((got.isnan() & want.isnan() & (got.view(ints) != want.view(ints)))
                            .sum())
                fail(f"{name}: {n_diff} outputs differ from the plain version's bits "
                     f"({n_nan} of them NaN in both)")
        if (dtype != torch.bfloat16 or B not in (INT8_BATCH, POOL_BATCH_WIDE)
                or not pool_cuda.fixed_volume(size, k, s)):
            continue
        nbytes = 2 * x.numel() * x.element_size()
        copies = [x] + [x.clone() for _ in range(-(-2 * L2_BYTES // nbytes) - 1)]
        rounds = -(-POOL_TIMED_CALLS // len(copies))
        ms, n = device_ms([lambda c=c: pool_cuda.avg_pool3d_cuda(c, k, s, True)
                           for c in copies] * rounds)
        plain_ms, plain_n = device_ms([lambda c=c: tnn.avg_pool3d_reference(c, k, s, True)
                                       for c in copies] * rounds)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        R = size[0]
        rows.append({"B": B, "C": C, "R": R, "k": k, "ms": ms, "launches": n,
                     "bound_ms": bound_ms, "bound_pct": 100 * bound_ms / ms, "bytes": nbytes,
                     "plain_ms": plain_ms, "plain_launches": plain_n})
        print(f"time: average pool [B={B}, C={C}, {R}^3, k={k}, bf16, relu]: {ms:.4f} ms of "
              f"device time in {n:g} launch, {100 * bound_ms / ms:.1f}% of its byte bound "
              f"{bound_ms:.4f} ms ({nbytes} bytes); plain {plain_ms:.4f} ms in {plain_n:g} "
              f"launches [{card}]", flush=True)
        del copies
    neg_zero = torch.full((2,), -0.0, device=dev)
    relu_neg_zero = {str(dt).removeprefix("torch."): "-0" if torch.relu(neg_zero.to(dt)).float()
                     .signbit().all() else "+0" for dt in (torch.bfloat16, torch.float32)}
    print(f"phase 5c: the average pool identical to its plain version at {n_cases} cases "
          f"({len(pools)} served shapes at 2 batches and {len(AVG_POOL_ELEMENT_WISE)} of the "
          f"element-wise kernel, 2 dtypes, ReLU off and on), one launch each; aten's ReLU of "
          f"-0 on the card {relu_neg_zero}; the phase took {time.perf_counter() - t5:.1f} s",
          flush=True)
    return rows, relu_neg_zero


def pool_launches(fn, counter: str = "max_pool3d") -> int:
    """A pool kernel's launches (`counter`: "max_pool3d" or "avg_pool3d") in
    one call of `fn` outside autograd."""
    import torch

    from nestinet_tpu_torch.ops.kernels import pool_cuda

    lib = next(lib for lib in pool_cuda.KERNELS if counter in lib.launches)
    lib.reset_launches()
    with torch.inference_mode():
        fn()
    return lib.launches[counter]


def device_launches(fn) -> int:
    """Device launches (kernels and memsets) of one call of `fn`, from
    torch.profiler's device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.self_device_time_total > 0)


def check_extraction(dev, data, shape, radii_frac):
    """Phase 5: one batch of DEVICE_BATCH queries per radius, extracted on
    the card and on the CPU from the same inputs; returns the batch's
    inputs for timing."""
    import numpy as np
    import torch

    from nestinet_tpu_torch.data.pcpnet import _load_cached
    from nestinet_tpu_torch.infer.device_pipeline import _dataset_window_caps
    from nestinet_tpu_torch.ops import ball_query as bq

    cloud = _load_cached(os.path.join(data, shape + ".xyz"), np.float32)
    rng = np.random.RandomState(SEED)
    shuffled = cloud[rng.permutation(cloud.shape[0])]
    queries = cloud[:DEVICE_BATCH]
    caps = _dataset_window_caps([cloud], radii_frac)
    bbdiag = float(np.linalg.norm(cloud.max(0) - cloud.min(0)))
    radii = [r * bbdiag for r in radii_frac]
    places = {"card": dev, "cpu": torch.device("cpu")}
    grids = {k: [bq.build_grid(torch.from_numpy(shuffled).to(d), r) for r in radii]
             for k, d in places.items()}
    seed = int(rng.randint(0, 2**31))
    for i, (radius, cap) in enumerate(zip(radii, caps)):
        g_card, g_cpu = grids["card"][i], grids["cpu"][i]
        for field in bq.HashGrid._fields:
            if not torch.equal(getattr(g_card, field).cpu(), getattr(g_cpu, field)):
                fail(f"grid field {field} differs between the card and the CPU (r={radius})")
        out = {}
        for k, d in places.items():
            q = torch.from_numpy(queries).to(d)
            rows, _, took, n_eff = bq._query_select(
                grids[k][i], q, radius, k=512, cell_capacity=64, seed=seed + i,
                window_capacity=cap)
            patch, _ = bq.extract_patches(grids[k][i], q, radius, k=512, seed=seed + i,
                                          window_capacity=cap)
            out[k] = [t.cpu() for t in (rows, took, n_eff, patch)]
        for name, a, b in zip(("rows", "took_hit", "n_eff"), out["card"], out["cpu"]):
            if not torch.equal(a, b):
                fail(f"extraction {name} differs between the card and the CPU (r={radius})")
        perr = (out["card"][3] - out["cpu"][3]).abs().max().item()
        n_eff = out["card"][2]
        print(f"extraction r={radius:.4f} (lanes {cap}): rows, hit masks, n_eff identical "
              f"on card and CPU; patches max abs diff {perr:.1e}; n_eff min "
              f"{int(n_eff.min())} mean {float(n_eff.float().mean()):.1f} max "
              f"{int(n_eff.max())}", flush=True)
        if not perr <= EXTRACT_ATOL:
            fail(f"extracted patches differ between the card and the CPU: {perr}")
    return grids["card"], torch.from_numpy(queries).to(dev), radii, seed, caps


def check_outputs(data, out_dir, testset, n_experts):
    """Every `.normals` row finite, every `.experts` id in range (a model
    other than the mixture of experts, `n_experts` None, writes none), a
    finite RMS; returns the evaluation summary."""
    import numpy as np

    from nestinet_tpu_torch.eval.evaluate import evaluate_dataset

    with open(os.path.join(data, testset + ".txt")) as f:
        shapes = [s.strip() for s in f if s.strip()]
    for shape in shapes:
        n_pts = np.loadtxt(os.path.join(data, shape + ".xyz")).shape[0]
        normals = np.loadtxt(os.path.join(out_dir, shape + ".normals"))
        if normals.shape != (n_pts, 3) or not np.isfinite(normals).all():
            fail(f"{shape}.normals: shape {normals.shape} or non-finite values")
        if n_experts is None:
            if os.path.exists(os.path.join(out_dir, shape + ".experts")):
                fail(f"{shape}.experts written for a model without experts")
            continue
        experts = np.loadtxt(os.path.join(out_dir, shape + ".experts"))
        if experts.shape != (n_pts,) or experts.min() < 0 or experts.max() >= n_experts:
            fail(f"{shape}.experts: bad shape or ids out of [0, {n_experts})")
    summary = evaluate_dataset(data, out_dir, testset, log=lambda *_: None)
    if not np.isfinite(summary["rms"]):
        fail(f"RMS is not finite ({out_dir})")
    return summary


def int8_launches(launches: dict) -> int:
    """The int8 kernels' launches in a dict of launch counts: the conv
    kernels' (k > 1) and the GEMM's (k = 1)."""
    return sum(launches.get(k, 0) for k in INT8_COUNTERS)


def int8_calls(model) -> dict:
    """The int8 launches of one call of the manager and of one expert run
    (a dense model: of one call of the model, and no run), one a conv or
    linear layer: {"all": (manager, expert), "int8_gemm": the same for the
    layers `int8_cuda.kernel_for` sends to the GEMM at their input's shape
    and a batch of DEVICE_BATCH on the card}.  The shapes come from one
    float32 call of each part on the card on a zero grid of one patch (the
    model before quantizing; it goes back where it lay), with a hook on
    every layer.  Every expert must make the same numbers."""
    import torch

    from nestinet_tpu_torch.ops import quant
    from nestinet_tpu_torch.ops.kernels import int8_cuda
    from nestinet_tpu_torch.ops.nn import _Conv3D, _Linear

    home = next(model.parameters()).device
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = int8_cuda.sm_count(dev.index)
    grid = torch.zeros((1,) + (model.resolution,) * 3 + (20 * model.cfg.n_scales,),
                       dtype=torch.float32, device=dev)

    def layers(fn):
        kernels = []

        def hook(mod, args):
            x = args[0]
            C, (D, H, W) = x.shape[1], tuple(x.shape[2:]) if x.dim() == 5 else (1, 1, 1)
            k, cout = getattr(mod, "kernel", 1), mod.b.shape[0]
            bm, bn = int8_cuda.tile_shape(DEVICE_BATCH * D * H * W, cout, sms)
            kernels.append(int8_cuda.kernel_for(C, D, H, W, quant.padded_channels(C), k, bm, bn))

        hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
                 if isinstance(m, (_Conv3D, _Linear))]
        try:
            with torch.inference_mode():
                fn()
        finally:
            for h in hooks:
                h.remove()
        return len(kernels), kernels.count("gemm")

    model.to(dev)
    try:
        if hasattr(model, "experts"):
            experts = {layers(lambda: model.expert_on_grid(i, grid))
                       for i in range(len(model.experts))}
            manager = layers(lambda: model.manager_probs(grid))
        else:
            experts, manager = {(0, 0)}, layers(lambda: model.forward_grid(grid))
    finally:
        model.to(home)
    if len(experts) != 1:
        fail(f"the experts differ in their int8 layers: {sorted(experts)}")
    (m_all, m_k1), (e_all, e_k1) = manager, experts.pop()
    return {"all": (m_all, e_all), "int8_gemm": (m_k1, e_k1)}


def check_int8_launches(name: str, launches: dict, batches: int, runs: int, per_call) -> int:
    """Fail unless an int8 path launched the int8 kernels once a layer of
    the manager (or dense model) a batch and of the expert a run, and the
    GEMM once a k = 1 layer (`int8_calls`); returns the count."""
    got = int8_launches(launches)
    (m_all, e_all), k1 = per_call["all"], per_call["int8_gemm"]
    want = batches * m_all + runs * e_all
    if got != want:
        fail(f"{name}: {got} int8 kernel launches, where {batches} batches and {runs} "
             f"expert runs make {want} ({m_all} a manager call, {e_all} a run)")
    if launches["int8_gemm"] != batches * k1[0] + runs * k1[1]:
        fail(f"{name}: {launches['int8_gemm']} int8 GEMM launches, where the k = 1 layers "
             f"make {batches * k1[0] + runs * k1[1]} ({k1[0]} a manager call, {k1[1]} a run)")
    return want


def routing_line(stats: dict) -> str:
    """The router's counts of a routed serving call, for its printed line."""
    if "expert_runs" not in stats:
        return ""
    return (f", expert runs {stats['expert_runs']} ({stats['forced_flushes']} forced "
            f"flushes, window {stats['window_slots']} slots)")


def serve(name, fn, kernels, card, int8: bool = False, int8_per=None):
    """Drive one serving path with every launch count at 0; check that it
    launched the MuPS kernel once per batch, and the int8 kernels if and
    only if it serves int8; in int8, as often as its batches and expert
    runs make with `int8_per` (`int8_calls`)."""
    import torch

    for k in kernels:
        k.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = fn()
    launches = {n: c for k in kernels for n, c in k.launches.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    extra = (f", loader wait {stats['loader_wait_seconds']:.2f} s"
             if "loader_wait_seconds" in stats else "")
    print(f"{name}: {stats['n_patches']} patches in {stats['n_batches']} batches, "
          f"{stats['seconds']:.2f} s, {stats['patches_per_sec']:.1f} patches/s{extra}, "
          f"peak {peak_gb:.2f} GB, launches {launches}{routing_line(stats)}, patches per "
          + (f"branch {stats['branch_rows']}" if "branch_rows" in stats
             else f"expert {stats.get('expert_rows')}") + f" [{card}]", flush=True)
    if launches["tdmfv_n_est"] != stats["n_batches"]:
        fail(f"{name}: MuPS launches {launches['tdmfv_n_est']} != batches "
             f"{stats['n_batches']}")
    if int8 != (int8_launches(launches) > 0):
        fail(f"{name}: {int8_launches(launches)} int8 kernel launches")
    for pool in ("max_pool3d", "avg_pool3d"):
        if launches.get(pool, 0) < stats["n_batches"]:
            fail(f"{name}: {launches.get(pool, 0)} {pool} launches for {stats['n_batches']} "
                 f"batches")
    if int8 and int8_per is not None:
        check_int8_launches(name, launches, stats["n_batches"], stats.get("expert_runs", 0),
                            int8_per)
    if "jax" in sys.modules:
        fail("jax was imported")
    stats = {k: v for k, v in stats.items() if k not in ("shapes",)}
    stats.update(peak_memory_gb=peak_gb, launches=launches)
    return stats


def device_time_split(fn):
    """One call of `fn` under torch.profiler (device activity only, so
    each row is a kernel): (device ms, share of convolution kernels, share
    of the int8 kernels, share of the int8 GEMM alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = conv = int8 = gemm = 0.0
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        total += us
        if "int8_gemm" in evt.key:
            gemm += us
        if any(t in evt.key for t in INT8_COUNTERS):
            int8 += us
        elif any(t in evt.key for t in ("conv", "fprop")):
            conv += us
    if total <= 0:
        return float("nan"), float("nan"), float("nan"), float("nan")
    return total / 1e3, conv / total, int8 / total, gemm / total


def route_one(model, grid, real):
    """One padded batch routed on its own through the router
    (`SparseMoeRouter`, two FIFO slots): the manager on the whole batch,
    its first `real` rows routed, the runs flushed at `finish`, one run an
    expert with rows.  Returns (normals, ids, probs) as NumPy arrays."""
    import numpy as np

    from nestinet_tpu_torch.infer.predict import SparseMoeRouter

    out = []
    router = SparseMoeRouter(model, grid.shape[0], lambda *o: out.append(o),
                             device=grid.device, window_slots=2)
    router.serve(real, grid, model.gate(grid))
    router.finish()
    return tuple(np.concatenate(part) for part in zip(*out))


def int8_launch_counts(model, grid, real) -> dict:
    """Device launches under int8 (`torch.profiler`): one batch routed on
    its own through the router (`route_one`: the manager, one expert run
    per expert with rows, the router's index uploads and fetches), its int8
    kernel launches, the manager on the batch and one expert run of B rows
    (the router's unit: a served batch makes one manager call and its share
    of the runs), one conv of the manager with a forwarded bound (incep0's
    k = 3 conv on its 1x1x1 conv's output) and the grid's first conv; and
    each int8 kernel's own count (its wrapper's) of one manager call and of
    one expert run."""
    import torch

    from nestinet_tpu_torch.ops.kernels import int8_cuda

    def counted(fn):
        for k in int8_cuda.KERNELS:
            k.reset_launches()
        fn()
        return {n: c for k in int8_cuda.KERNELS for n, c in k.launches.items()}

    x = grid.permute(0, 4, 1, 2, 3)  # the manager's NCDHW input
    block = model.manager.backbone.incep0
    with torch.inference_mode():
        one = block.conv1(x)
        kernel = int8_launches(counted(lambda: route_one(model, grid, real)))
        return {"routed_batch": device_launches(lambda: route_one(model, grid, real)),
                "int8_kernel": kernel,
                "kernels_manager": counted(lambda: model.manager_probs(grid)),
                "kernels_expert_run": counted(lambda: model.expert_on_grid(0, grid)),
                "manager": device_launches(lambda: model.manager_probs(grid)),
                "expert_run": device_launches(lambda: model.expert_on_grid(0, grid)),
                "per_conv": device_launches(lambda: block.conv2(one)),
                "per_first_conv": device_launches(lambda: block.conv1(x))}


def one_batch(model, grid, real):
    """Routed (`route_one`) and dense on one grid: (normals, ids, probs)
    each way, on the grid's device."""
    import torch

    with torch.inference_mode():
        routed = tuple(torch.from_numpy(a).to(grid.device) for a in route_one(model, grid, real))
        out = model.forward_grid(grid)
        ids_d, probs_d = model.predict_experts(out)
        dense = (model.predict_normals(out)[:real], ids_d[:real], probs_d[:real])
        torch.cuda.synchronize()
    return routed, dense


def angles_deg(a, b):
    import torch

    cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)
    return torch.rad2deg(torch.arccos(cos.clamp(-1.0, 1.0)))


def bn_fed_biases(model) -> dict:
    """{bias name: its layer's kernel name} for the conv and linear biases
    that feed a train-mode BatchNorm, whose exact gradient is 0."""
    from nestinet_tpu_torch.ops.nn import ConvBN3D, DenseBN

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ConvBN3D):
            out[f"{name}.conv.b"] = f"{name}.conv.w"
        elif isinstance(m, DenseBN) and m.bn is not None:
            out[f"{name}.linear.b"] = f"{name}.linear.w"
    return out


def gradient_errors(grads: dict, ref: dict, noisy: dict) -> dict:
    """Relative L2 errors of `grads` against `ref` (float64 on the CPU,
    by parameter name): each tensor's ("by_tensor", the worst in "worst"),
    all of them at once ("all"), and the BN-fed biases' against their
    kernel's gradient norm ("bias")."""
    import torch

    by_tensor, diff2, ref2, bias = {}, 0.0, 0.0, 0.0
    for name, r in ref.items():
        d = torch.linalg.norm(grads[name] - r).item()
        if name in noisy:
            bias = max(bias, d / torch.linalg.norm(ref[noisy[name]]).item())
            continue
        rn = torch.linalg.norm(r).item()
        by_tensor[name] = d / rn if rn > 0 else d
        diff2, ref2 = diff2 + d * d, ref2 + rn * rn
    worst = max(by_tensor, key=by_tensor.get)
    return {"by_tensor": by_tensor, "worst": (worst, by_tensor[worst]),
            "all": (diff2 / ref2) ** 0.5, "bias": bias}


def step_gradients(model, cfg, batch):
    """One train step at step 0; (loss, {name: gradient as float64 on the
    CPU})."""
    import torch

    from nestinet_tpu_torch.train.train_step import make_optimizer, make_train_step

    loss = make_train_step(model, cfg, make_optimizer(model, cfg))(batch, 0)
    grads = {n: p.grad.detach().cpu().double() for n, p in model.named_parameters()}
    return loss.item(), grads


def perturbed(batch: dict, rel: float, seed: int) -> dict:
    """The batch with its points scaled by 1 + rel U(-1, 1), per coordinate."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pts = batch["points"]
    u = (2 * torch.rand(pts.shape, generator=g) - 1).to(pts.device)
    return dict(batch, points=pts * (1 + rel * u))


def training_batch(dev, batch: int, seed: int, radii_frac=(0.01, 0.03, 0.05)):
    """One batch of `batch` patches at PCPNet's density (`served_rows`:
    extracted on the card from a 100,000-point sphere at `radii_frac`) with
    random unit normals and noise levels in [0, 0.03) as targets, on
    `dev`."""
    import numpy as np
    import torch

    from nestinet_tpu_torch.scripts.mups_kernel_parts import served_rows

    with torch.no_grad():
        pts, ne = served_rows(dev, seed, batch=batch, radii_frac=radii_frac)
    rng = np.random.RandomState(seed)
    normals = rng.normal(size=(batch, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    noise = rng.uniform(0.0, 0.03, size=batch).astype(np.float32)
    return {"points": pts.reshape(batch, -1, 3).clone(), "n_eff": ne.reshape(batch, -1).clone(),
            "normals": torch.from_numpy(normals).to(dev), "noise": torch.from_numpy(noise).to(dev)}


def check_train_step_against_cpu(dev, cfg, gmm, kernel):
    """Phase 13a: one full-width float32 train step on the card against the
    same step on the CPU, from the same weights and batch: the loss at rtol
    1e-5 and the BatchNorm state at atol 1e-5.  The gradients are held to
    float32's own sensitivity of this step, measured in the same run: the
    CPU step again on points moved by 1e-7 relative gives each tensor's
    spread; the card's relative L2 error may be 4x the worst tensor's
    spread on each tensor and 4x the whole gradient's spread over all of
    them; a bias that feeds a train-mode BatchNorm (its gradient is
    rounding noise) stays within 1e-4 of its kernel's gradient norm.  The
    card's step launches the MuPS kernel once and never calls its
    backward; the eval step launches it once."""
    import copy

    import torch

    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.train.train_step import make_eval_step

    cpu_model = build_model(cfg, gmm, torch.Generator().manual_seed(SEED))
    card_model = copy.deepcopy(cpu_model).to(dev)
    batch = training_batch(dev, TRAIN_CHECK_BATCH, SEED)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    noisy = bn_fed_biases(cpu_model)
    kernel.reset_launches()
    mups_ops.BACKWARD_CALLS["plain"] = 0
    card_loss, card_grads = step_gradients(card_model, cfg, batch)
    launches = dict(kernel.launches)
    backward_calls = mups_ops.BACKWARD_CALLS["plain"]
    kernel.reset_launches()
    eval_loss, eval_cos = make_eval_step(card_model)(batch)
    torch.cuda.synchronize()
    eval_launches = kernel.launches["tdmfv_n_est"]
    if not (torch.isfinite(eval_loss) and torch.isfinite(eval_cos).all()):
        fail("the eval step's loss or cosines are not finite")
    t0 = time.perf_counter()
    fresh = copy.deepcopy(cpu_model)  # the perturbed step starts from the same state
    cpu_loss, cpu_grads = step_gradients(cpu_model, cfg, cpu_batch)
    cpu_s = time.perf_counter() - t0
    _, spread_grads = step_gradients(fresh, cfg, perturbed(cpu_batch, TRAIN_PERTURB_REL, SEED))
    card = gradient_errors(card_grads, cpu_grads, noisy)
    spread = gradient_errors(spread_grads, cpu_grads, noisy)
    tensor_bar = max(TRAIN_GRAD_SPREADS * spread["worst"][1], 1e-4)
    all_bar = max(TRAIN_GRAD_SPREADS * spread["all"], 1e-4)
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    cpu_state = dict(cpu_model.named_buffers())
    bn_err = max((b.cpu() - cpu_state[n]).abs().max().item()
                 for n, b in card_model.named_buffers() if n.rsplit(".", 1)[-1] in
                 ("ema_mean", "ema_var", "bias"))
    over = sum(e > 1e-4 for e in card["by_tensor"].values())
    print(f"train step, card vs CPU [full width, f32, B={TRAIN_CHECK_BATCH}]: loss "
          f"{card_loss:.6f} vs {cpu_loss:.6f} (rel err {loss_err:.2e}, rtol {TRAIN_LOSS_RTOL}); "
          f"BN state max abs err {bn_err:.2e} (atol {TRAIN_BN_ATOL}); gradients, relative L2: "
          f"worst tensor {card['worst'][1]:.2e} ({card['worst'][0]}), all {card['all']:.2e}, "
          f"{over} of {len(card['by_tensor'])} tensors over 1e-4; the CPU's own spread at "
          f"points moved by {TRAIN_PERTURB_REL:g}: worst tensor {spread['worst'][1]:.2e} "
          f"({spread['worst'][0]}), all {spread['all']:.2e}; bars {tensor_bar:.2e} and "
          f"{all_bar:.2e}; BN-fed biases {card['bias']:.2e} of their kernel's (bar "
          f"{TRAIN_BIAS_RTOL}); MuPS launches {launches}, plain backward calls "
          f"{backward_calls}, eval step MuPS launches {eval_launches}; the CPU step took "
          f"{cpu_s:.1f} s", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        fail(f"train step loss differs between the card and the CPU: {loss_err}")
    if not (card["worst"][1] <= tensor_bar and card["all"] <= all_bar
            and card["bias"] <= TRAIN_BIAS_RTOL):
        fail(f"train step gradients differ between the card and the CPU: {card['worst']}, "
             f"all {card['all']}, biases {card['bias']}")
    if not bn_err <= TRAIN_BN_ATOL:
        fail(f"BatchNorm state differs between the card and the CPU: {bn_err}")
    if launches["tdmfv_n_est"] != 1 or backward_calls != 0 or eval_launches != 1:
        fail(f"train step: {launches} MuPS launches, {backward_calls} backward calls; eval "
             f"step: {eval_launches} launches")
    return {"mups_launches_train_step": launches["tdmfv_n_est"],
            "mups_launches_eval_step": eval_launches, "plain_backward_calls": backward_calls,
            "loss_rel_err": loss_err, "bn_state_max_abs_err": bn_err,
            "grad_worst": card["worst"], "grad_all": card["all"], "grad_over_1e-4": over,
            "spread_worst": spread["worst"], "spread_all": spread["all"],
            "bn_fed_bias_grad_err": card["bias"], "cpu_step_s": cpu_s}


def time_train_steps(dev, cfg, gmm, dtype, kernel, card, steps=None):
    """Phase 13b (and 14b, for each ablation model in float32): the
    full-width train step at B = 256 (or the largest batch that fits) on
    one fixed batch, `steps` steps (TRAIN_STEPS[dtype] by default): ms per
    step (CUDA events, the median of steps 3-10),
    patches/s, peak memory, MuPS launches per step, the MuPS kernel's share
    of the step; the loss after the last adam step must be below the first
    step's."""
    import dataclasses

    import torch

    from nestinet_tpu_torch.core.device import cuda_median_ms
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.train.train_step import make_optimizer, make_train_step

    steps = steps or TRAIN_STEPS[dtype]
    for batch_size in TRAIN_BATCHES:
        c = dataclasses.replace(cfg, compute_dtype=dtype, batch_size=batch_size)
        model = build_model(c, gmm, torch.Generator().manual_seed(SEED)).to(dev)
        step_fn = make_train_step(model, c, make_optimizer(model, c))
        batch = training_batch(dev, batch_size, SEED + 1, cfg.patch_radius)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.reset_launches()
        try:
            times, losses = [], []
            for i in range(steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                losses.append(step_fn(batch, i))
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        except torch.cuda.OutOfMemoryError:
            print(f"train step {dtype}: B={batch_size} does not fit", flush=True)
            del model, step_fn, batch
            torch.cuda.empty_cache()
            continue
        break
    else:
        fail(f"train step {dtype}: no batch of {TRAIN_BATCHES} fits")
    launches = kernel.launches["tdmfv_n_est"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = sorted(times[2:10])[len(times[2:10]) // 2]
    with torch.no_grad():
        mups_ms = cuda_median_ms(lambda: model.mups_grid(batch["points"], batch["n_eff"]),
                                 warmup=2, iters=10)
    losses = [x.item() for x in losses]
    out = {"batch": batch_size, "ms": ms, "patches_per_s": batch_size / ms * 1e3,
           "peak_memory_gb": peak_gb, "mups_launches_per_step": launches / steps,
           "mups_ms": mups_ms, "mups_share": mups_ms / ms, "first_loss": losses[0],
           "last_loss": losses[-1], "steps": steps, "step_ms": times}
    print(f"train step {cfg.model} {dtype} [full width, B={batch_size}]: {ms:.1f} ms (median of steps "
          f"3-{min(steps, 10)}), {out['patches_per_s']:.1f} patches/s, peak {peak_gb:.2f} GB, MuPS "
          f"{launches / steps:g} launches per step, {mups_ms:.3f} ms "
          f"({100 * out['mups_share']:.2f}% of the step); loss {losses[0]:.4f} at step 1, "
          f"{losses[-1]:.4f} at step {steps} [{card}]", flush=True)
    if launches != steps:
        fail(f"train step {dtype}: {launches} MuPS launches in {steps} steps")
    if not losses[-1] < losses[0]:
        fail(f"train step {dtype}: the loss did not fall in {steps} steps: {losses}")
    del model, step_fn
    torch.cuda.empty_cache()
    return out


def train_cli(data, run, *extra):
    """Phase 13c: `python -m nestinet_tpu_torch.cli.train` at full width on
    the synthetic training and validation sets, B = 256."""
    args = ["--data_path", data, "--log_dir", run, "--trainset", "trainingset_whitenoise.txt",
            "--testset", "validationset.txt", "--patch_radius", "0.01", "0.03", "0.05",
            "--num_point", "512", "--num_gaussians", "8", "--batch_size", "256",
            "--patches_per_shape", str(TRAIN_PATCHES_PER_SHAPE), "--seed", str(SEED),
            "--insert_rotation_augmentation", "1", *extra]
    return run_module("nestinet_tpu_torch.cli.train", *args)


def run_module(module, *args) -> float:
    """Run `python -m module args` from the checkout's root; raise on a
    non-zero exit, print its output's last lines; returns its seconds."""
    return run_modules([(module, args)])[0]


def run_modules(calls) -> list:
    """Run several `python -m module args` at once, each from the
    checkout's root; wait for all, print each one's last lines, raise if
    one exited non-zero; returns their seconds."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=root)
             for module, args in calls]
    secs, errors = [], []
    try:
        for (module, _), proc in zip(calls, procs):
            out, err = proc.communicate(timeout=600)
            secs.append(time.perf_counter() - t0)
            for line in out.strip().splitlines()[-12:]:
                print(f"  {module}: {line}", flush=True)
            if proc.returncode != 0:
                errors.append(f"{module} exited {proc.returncode}:\n{err[-3000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if errors:
        fail("\n".join(errors))
    return secs


def check_trained_run(data, run):
    """Phase 13c: the run dir after 2 epochs and a resume to 3: metrics of
    3 train and 3 eval epochs, the periodic checkpoint at epoch 2, a best
    checkpoint; then `cli.test --extraction=device` serves it from the best
    checkpoint: finite normals and RMS."""
    import json as _json

    import numpy as np
    import torch

    from nestinet_tpu_torch.core import checkpoint

    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = [_json.loads(line) for line in f]
    kinds = [m["kind"] for m in metrics]
    with open(os.path.join(run, "log_train.txt")) as f:
        log = f.read()
    periodic = checkpoint.load(run, torch.device("cpu"))
    best = checkpoint.load(run, torch.device("cpu"), best=True)
    print(f"trained run: metrics {kinds}, eval RMS "
          f"{[round(m['rms_deg'], 3) for m in metrics if m['kind'] == 'eval']} deg, periodic "
          f"checkpoint epoch {periodic['epoch']} step {periodic['step']}, best epoch "
          f"{best['epoch']}", flush=True)
    if kinds != ["train", "eval"] * 3 or periodic["epoch"] != 2:
        fail(f"the trained run holds {kinds}, periodic epoch {periodic['epoch']}")
    if "resumed from epoch 1" not in log or os.path.exists(os.path.join(run, "1")):
        fail("the second cli.train call did not resume the run in place")
    if not all(np.isfinite(m["loss"]) for m in metrics):
        fail("non-finite loss in metrics.jsonl")
    secs = run_module("nestinet_tpu_torch.cli.test", "--results_path", run,
                      "--dataset_path", data, "--testset", "testset_two.txt",
                      "--dataset_name", "trained", "--extraction", "device",
                      "--batch_size", str(DEVICE_BATCH))
    summary = check_outputs(data, os.path.join(run, "trained_results"), "testset_two",
                            N_EXPERTS)
    print(f"cli.test of the trained run (best checkpoint, epoch {best['epoch']}, device "
          f"extraction, bf16, 10,000 patches): RMS {summary['rms']:.4f} deg, PGP10 "
          f"{summary['pgp10']:.4f}, {secs:.1f} s", flush=True)
    return {"metrics": metrics, "best_epoch": best["epoch"], "rms": summary["rms"],
            "test_seconds": secs}


def check_tb_and_trace(run):
    """Phase 13c: the run's TensorBoard events (`<run>/tb/`, read with the
    port's own framing and CRC) hold every numeric scalar of its
    `metrics.jsonl` under `<kind>/<key>` at the record's step, and the
    trace of epoch 1 (`<run>/profile/`) names MuPS kernel 1 once per train
    step of that epoch; prints the traced epoch's step times beside the
    untraced ones."""
    import json as _json

    import numpy as np

    from nestinet_tpu_torch.core.tb import read_scalars

    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = [_json.loads(line) for line in f]
    want = sorted(
        (f"{m['kind']}/{k}", int(m["step"]), float(np.float32(v)))
        for m in metrics for k, v in m.items()
        if k not in ("kind", "step", "time") and isinstance(v, (int, float))
        and not isinstance(v, bool))
    got = sorted(read_scalars(os.path.join(run, "tb")))
    print(f"tensorboard: {len(got)} scalar records in "
          f"{len(os.listdir(os.path.join(run, 'tb')))} event files; metrics.jsonl has "
          f"{len(want)} numeric scalars", flush=True)
    if got != want:
        fail(f"the TensorBoard events differ from metrics.jsonl: "
             f"{sorted(set(got) ^ set(want))[:5]}")
    traces = sorted(os.listdir(os.path.join(run, "profile")))
    if len(traces) != 1:
        fail(f"profile/ holds {traces}, not one trace")
    path = os.path.join(run, "profile", traces[0])
    with open(path) as f:
        events = _json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    mups = [e for e in kernels if "tdmfv_n_est_kernel" in e.get("name", "")]
    train = {m["epoch"]: m for m in metrics if m["kind"] == "train"}
    steps = train[1]["step"] - train[0]["step"]
    print(f"trace of epoch 1: {os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events, "
          f"{len(kernels)} CUDA kernel events, {len(mups)} of tdmfv_n_est_kernel for "
          f"{steps} train steps", flush=True)
    if len(mups) != steps:
        fail(f"the trace names tdmfv_n_est_kernel {len(mups)} times for {steps} steps")
    for epoch, m in sorted(train.items()):
        print(f"time: epoch {epoch} ({'traced' if epoch == 1 else 'untraced'}"
              f"{', resumed process' if epoch == 2 else ''}): {m['step_steps']} steps, "
              f"{m['step_total_s']:.3f} s, median step {m['step_p50_ms']:.1f} ms", flush=True)
    return {"tb_scalars": len(got), "trace_mb": os.path.getsize(path) / 1e6,
            "trace_kernel_events": len(kernels), "trace_mups_kernel_events": len(mups),
            "epoch_step_p50_ms": {e: m["step_p50_ms"] for e, m in train.items()},
            "epoch_step_total_s": {e: m["step_total_s"] for e, m in train.items()}}


# ---------------------------------------------------------------- phase 15

def scan_frame(seed: int, h: int = SCAN_H, w: int = SCAN_W, f: float = SCAN_F):
    """Phase 15a's depth frame: a floor, a wall and a sphere ray-cast from
    a camera with ScanNet's depth intrinsics halved (or, with `h`, `w` and
    `f`, scaled otherwise), in millimetres (uint16) with about 10% holes;
    and a camera-to-world pose with a rotation and a translation.  Rays
    follow `depth_to_xyz`'s 1-based pixels: pixel (x, y) looks along K^-1
    (x + 1, y + 1, 1), and its depth is the hit's z."""
    import numpy as np

    rng = np.random.RandomState(seed)
    fx = fy = f
    cx, cy = (w - 1) / 2, (h - 1) / 2
    intrinsic = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    yy, xx = np.mgrid[:h, :w]
    rx, ry = (xx + 1 - cx) / fx, (yy + 1 - cy) / fy  # ray (rx, ry, 1)
    t = np.full((h, w), 3.5)  # the wall, z = 3.5 m
    floor = np.where(ry > 0, 1.0 / np.maximum(ry, 1e-9), np.inf)  # y = 1 m (y is down)
    t = np.minimum(t, floor)
    c, radius = np.array([0.25, 0.35, 2.2]), 0.5
    a = rx * rx + ry * ry + 1.0
    b = rx * c[0] + ry * c[1] + c[2]
    disc = b * b - a * (c @ c - radius * radius)
    hit = (b - np.sqrt(np.maximum(disc, 0.0))) / a
    t = np.where((disc > 0) & (hit > 0), np.minimum(t, hit), t)
    depth = np.round(t * 1000 + rng.normal(0, 2, t.shape)).astype(np.uint16)
    depth[rng.rand(h, w) < 0.1] = 0
    ang = np.deg2rad([-20.0, 10.0])
    rot_x = np.array([[1, 0, 0], [0, np.cos(ang[0]), -np.sin(ang[0])],
                      [0, np.sin(ang[0]), np.cos(ang[0])]])
    rot_z = np.array([[np.cos(ang[1]), -np.sin(ang[1]), 0],
                      [np.sin(ang[1]), np.cos(ang[1]), 0], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, :3] = rot_z @ rot_x
    pose[:3, 3] = [1.5, 0.3, 1.2]
    return depth, intrinsic, pose


def write_png16(path, img):
    """A 16-bit grayscale PNG (no PIL on the card): even rows Sub-filtered,
    odd rows Up-filtered, so the reader undoes two filter types."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape
    raw = np.frombuffer(img.astype(">u2").tobytes(), np.uint8).reshape(h, 2 * w)
    sub = raw.copy()
    sub[:, 2:] = raw[:, 2:] - raw[:, :-2]
    up = raw.copy()
    up[1:] = raw[1:] - raw[:-1]
    rows = np.where((np.arange(h) % 2 == 0)[:, None], sub, up)
    kinds = np.where(np.arange(h) % 2 == 0, 1, 2).astype(np.uint8)[:, None]
    body = zlib.compress(np.concatenate([kinds, rows], axis=1).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
                + chunk(b"IDAT", body) + chunk(b"IEND", b""))


def projected_mask(points, intrinsic, pose):
    """[H, W] the pixels `world_to_image` writes: each point through the
    inverse pose (translation included) and K, rounded half away from
    zero, 1-based bounds."""
    import numpy as np

    cam = np.linalg.inv(pose) @ np.c_[points, np.ones(len(points))].T
    pix = intrinsic @ cam[:3]
    x = np.floor(pix[0] / pix[2] + 0.5).astype(np.int64)
    y = np.floor(pix[1] / pix[2] + 0.5).astype(np.int64)
    ok = (x > 0) & (y > 0) & (x <= SCAN_W) & (y <= SCAN_H)
    mask = np.zeros((SCAN_H, SCAN_W), bool)
    mask[y[ok] - 1, x[ok] - 1] = True
    return mask


def phase15a(tmp, run, kernels, card):
    """Phase 15a: the scan at full width on phase 7's run dir (float32):
    `predict_scan` in process with the launch counts at 0 (one MuPS launch
    a batch), then `python -m nestinet_tpu_torch.cli.scan` end to end on a
    frame of the same scene at 1/SCAN_CLI_DIV of its resolution, written as
    a 16-bit PNG, against `predict_scan` on that frame.  Checks the point
    count, finite normals, unit normals at the image's non-zero pixels, the
    image's zero mask against the projection, and the CLI's outputs against
    the in-process ones."""
    import numpy as np

    from nestinet_tpu_torch.infer.scan import load_depth, predict_scan

    t15 = time.perf_counter()
    depth, intrinsic, pose = scan_frame(SEED)
    valid = int(np.count_nonzero(depth))
    png = os.path.join(tmp, "scan_depth.png")
    write_png16(png, depth)
    if not np.array_equal(load_depth(png), depth):
        fail("load_depth does not read back the 16-bit PNG")
    out_dir = os.path.join(tmp, "scan_out")
    stats = serve("scan (predict_scan, host extraction, f32)", lambda: predict_scan(
        run, depth.astype(np.float64), intrinsic, pose, depth_shift=1000.0,
        batch_size=DEVICE_BATCH, output_dir=out_dir, project_to_image=True), kernels, card)
    points, img = stats.pop("points"), stats.pop("normal_image")
    # all-zero points cannot occur: the translation is dropped and K^-1 (u d, v d, d)
    # has z = d > 0, so every non-zero pixel is a point
    if points.shape != (valid, 3) or stats["n_patches"] != valid:
        fail(f"scan: {points.shape[0]} points, {stats['n_patches']} patches for {valid} "
             "non-zero pixels")
    normals = np.loadtxt(stats["normals_path"])
    experts = np.loadtxt(os.path.join(out_dir, "scan.experts"))
    if normals.shape != (valid, 3) or not np.isfinite(normals).all():
        fail(f"scan.normals: shape {normals.shape} or non-finite values")
    if experts.min() < 0 or experts.max() >= N_EXPERTS:
        fail("scan.experts: ids out of range")
    mask = np.any(img != 0, axis=-1)
    unit = np.abs(np.linalg.norm(img[mask], axis=-1) - 1.0).max()
    if img.shape != (SCAN_H, SCAN_W, 3) or not np.array_equal(mask, projected_mask(
            points, intrinsic, pose)) or not unit <= 1e-6:
        fail(f"scan image: shape {img.shape}, mask differs from the projection or normals "
             f"off unit length by {unit}")
    st = stats["stage_seconds"]
    print(f"scan: {SCAN_H}x{SCAN_W} frame, {valid} points ({valid / depth.size:.3f} of the "
          f"pixels), image {int(mask.sum())} pixels set; time depth->xyz "
          f"{st['depth_to_xyz']:.3f} s, staging write {st['staging']:.3f} s, serving "
          f"{st['serving']:.2f} s ({stats['patches_per_sec']:.1f} patches/s, loader wait "
          f"{stats['loader_wait_seconds']:.2f} s, peak {stats['peak_memory_gb']:.2f} GB), "
          f"projection {st['projection']:.3f} s [{card}]", flush=True)
    image_pixels = int(mask.sum())

    # the CLI's frame, and predict_scan on it as its reference
    depth, intrinsic, pose = scan_frame(SEED, SCAN_H // SCAN_CLI_DIV, SCAN_W // SCAN_CLI_DIV,
                                        SCAN_F / SCAN_CLI_DIV)
    write_png16(png, depth)
    small = serve("scan, 1/4 frame (predict_scan)", lambda: predict_scan(
        run, depth.astype(np.float64), intrinsic, pose, depth_shift=1000.0,
        batch_size=DEVICE_BATCH, output_dir=os.path.join(tmp, "scan_small"),
        project_to_image=True), kernels, card)
    normals = np.loadtxt(small["normals_path"])
    experts = np.loadtxt(os.path.join(tmp, "scan_small", "scan.experts"))
    mask = np.any(small.pop("normal_image") != 0, axis=-1)
    np.savetxt(os.path.join(tmp, "scan_intrinsic.txt"), intrinsic)
    np.savetxt(os.path.join(tmp, "scan_pose.txt"), pose)
    cli_dir = os.path.join(tmp, "scan_cli")
    secs = run_module("nestinet_tpu_torch.cli.scan", "--results_path", run, "--depth", png,
                      "--intrinsic", os.path.join(tmp, "scan_intrinsic.txt"), "--pose",
                      os.path.join(tmp, "scan_pose.txt"), "--depth_shift", "1000",
                      "--batch_size", str(DEVICE_BATCH), "--output_dir", cli_dir,
                      "--project_to_image", "1")
    cli_normals = np.loadtxt(os.path.join(cli_dir, "scan.normals"))
    cli_experts = np.loadtxt(os.path.join(cli_dir, "scan.experts"))
    cli_img = np.load(os.path.join(cli_dir, "scan_normals_img.npy"))
    same = cli_experts == experts
    err = float(np.abs(cli_normals[same] - normals[same]).max())
    scale = max(1.0, float(np.abs(normals).max()))  # random weights: |n| is not 1
    print(f"cli.scan: {small['n_patches']} points, {secs:.1f} s end to end; against "
          f"predict_scan on the same frame: experts equal on "
          f"{same.mean():.5f}, normals max abs diff {err:.3e} where they are (max |n| "
          f"{scale:.3g})", flush=True)
    if cli_normals.shape != normals.shape or same.mean() < 0.999 or not (
            err <= NORMALS_ATOL * scale):
        fail(f"cli.scan differs from predict_scan: experts {same.mean()}, normals {err}")
    if not np.array_equal(np.any(cli_img != 0, axis=-1), mask):
        fail("cli.scan's image is non-zero at other pixels than predict_scan's")
    stats.update(n_points=valid, cli_seconds=secs, cli_experts_equal=float(same.mean()),
                 cli_normals_max_abs_diff=err, cli_points=small["n_patches"],
                 image_pixels=image_pixels)
    print(f"phase 15a: the phase took {time.perf_counter() - t15:.1f} s", flush=True)
    return stats


def check_mups_variants(dev):
    """Phase 15b: the four 3DmFV variants on the card against the CPU on
    the same inputs (4 patches of 512 points, the flagship's 8^3
    Gaussians): finite, within KERNEL_ATOL."""
    import torch

    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    gen = torch.Generator().manual_seed(SEED + 15)
    points = torch.rand((4, 512, 3), generator=gen) * 1.6 - 0.8
    gmm = [torch.from_numpy(a) for a in get_3d_grid_gmm([8, 8, 8], variance=0.0156).astuple()]
    variants = {
        "tdmfv_classification": lambda *a: mups_ops.tdmfv_classification(*a),
        **{f"tdmfv_sym_{t}": lambda *a, t=t: mups_ops.tdmfv_sym(*a, sym_type=t)
           for t in ("max", "min", "ss")},
        "fv": lambda *a: mups_ops.fv(*a),
        "fv_unnormalized": lambda *a: mups_ops.fv(*a, normalize=False),
        "tdmfv_seg": lambda *a: torch.cat([o.reshape(4, -1) for o in mups_ops.tdmfv_seg(*a)], 1),
    }
    errs = {}
    for name, fn in variants.items():
        cpu = fn(points, *gmm)
        card_out = fn(points.to(dev), *(g.to(dev) for g in gmm)).cpu()
        errs[name] = (card_out - cpu).abs().max().item()
        if not (torch.isfinite(card_out).all() and errs[name] <= KERNEL_ATOL):
            fail(f"{name} on the card: finite {bool(torch.isfinite(card_out).all())}, "
                 f"max abs err {errs[name]} against the CPU")
    print("MuPS variants, card against CPU: " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items()) + f" (atol {KERNEL_ATOL})", flush=True)
    return errs


def phase15b(tmp, data, run, shapes, dev, kernels):
    """Phase 15b: `cli.synth` against `build_protocol_benchmark` file for
    file; `cli.test_all` (in process, one MuPS launch a batch) over two
    one-shape test lists on phase 7's run dir;
    `cli.evaluate --expert_statistics 1` of its results: finite RMS, the
    expert counts equal to the served ids; the MuPS variants on the card."""
    import filecmp
    import json as _json

    import numpy as np

    from nestinet_tpu_torch.cli import test_all
    from nestinet_tpu_torch.data.synthetic import build_protocol_benchmark
    from nestinet_tpu_torch.eval.expert_stats import compute_expert_statistics

    t15 = time.perf_counter()
    synth = {k: os.path.join(tmp, f"synth_{k}") for k in ("cli", "lib")}
    args = dict(n_points=SYNTH_POINTS, n_pidx=100, seed=SEED % 1000)
    synth_s = run_module("nestinet_tpu_torch.cli.synth", "--root", synth["cli"],
                         *(x for k, v in args.items() for x in (f"--{k}", str(v))))
    build_protocol_benchmark(synth["lib"], **args)
    names = sorted(os.listdir(synth["lib"]))
    _, mismatch, errors = filecmp.cmpfiles(synth["cli"], synth["lib"], names, shallow=False)
    if sorted(os.listdir(synth["cli"])) != names or mismatch or errors:
        fail(f"cli.synth differs from build_protocol_benchmark: {mismatch + errors}")
    print(f"cli.synth: {len(names)} files identical to build_protocol_benchmark's, "
          f"{synth_s:.1f} s", flush=True)

    lists = []
    for i, shape in enumerate(shapes[:2]):
        lists.append(f"scene{i}")
        with open(os.path.join(data, f"scene{i}.txt"), "w") as f:
            f.write(shape + "\n")
    with open(os.path.join(data, "scene_lists.txt"), "w") as f:
        f.write("\n".join(f"scene{i}.txt" for i in range(2)) + "\n")
    # in process, so that its launches are counted as the serving paths' are
    for k in kernels:
        k.reset_launches()
    t0 = time.perf_counter()
    test_all.main(["--results_path", run, "--dataset_path", data, "--testset_list",
                   "scene_lists.txt", "--dataset_name", "test_all", "--batch_size",
                   str(DEVICE_BATCH)])
    test_all_s = time.perf_counter() - t0
    launches = kernels[0].launches["tdmfv_n_est"]
    batches = sum(-(-np.loadtxt(os.path.join(data, s + ".xyz")).shape[0] // DEVICE_BATCH)
                  for s in shapes[:2])
    if launches != batches:
        fail(f"cli.test_all: {launches} MuPS launches for {batches} batches")
    results = os.path.join(run, "test_all_results")
    eval_s = run_module("nestinet_tpu_torch.cli.evaluate", "--normal_results_path", results,
                        "--data_path", data, "--dataset_list", *lists,
                        "--expert_statistics", "1")
    rms, served = {}, 0
    for name, shape in zip(lists, shapes):
        check_outputs(data, results, name, N_EXPERTS)
        with open(os.path.join(results, "summary", f"{name}_evaluation_results.txt")) as f:
            line = [x for x in f if x.startswith("RMS not oriented")][0]
        rms[name] = float(line.split(":")[1])
        with open(os.path.join(results, "images", "expert_statistics",
                               f"{name}_expert_statistics.json")) as f:
            stats = _json.load(f)
        experts = np.loadtxt(os.path.join(results, shape + ".experts")).astype(int)
        pidx = np.loadtxt(os.path.join(data, shape + ".pidx")).astype(int)
        if stats["count"] != np.bincount(experts[pidx], minlength=N_EXPERTS).tolist():
            fail(f"{name}: expert counts {stats['count']} differ from the served ids")
        whole = compute_expert_statistics(data, results, name, n_experts=N_EXPERTS,
                                          use_subset=False, log=lambda *_: None)
        served += experts.size
        if sum(whole["count"]) != experts.size:
            fail(f"{name}: expert counts sum to {sum(whole['count'])}, not the "
                 f"{experts.size} points served")
        if not np.isfinite(rms[name]):
            fail(f"{name}: RMS {rms[name]}")
    print(f"cli.test_all: two test lists, {served} points served, {launches} MuPS launches "
          f"(one a batch), {test_all_s:.1f} s; "
          f"cli.evaluate --expert_statistics 1 {eval_s:.1f} s: RMS " + ", ".join(
              f"{k} {v:.4f} deg" for k, v in rms.items()) + " (random weights); expert "
          "counts equal to the served ids", flush=True)
    errs = check_mups_variants(dev)
    print(f"phase 15b: the phase took {time.perf_counter() - t15:.1f} s", flush=True)
    return {"synth_seconds": synth_s, "test_all_seconds": test_all_s, "launches": launches,
            "evaluate_seconds": eval_s, "rms": rms, "mups_variants_max_abs_err": errs}


# ---------------------------------------------------------------- phase 14


def check_branch_share(name: str, stats: dict) -> None:
    """The switching model's share of served patches in each branch,
    printed; a branch that served none fails the run."""
    if "branch_rows" not in stats:
        return
    rows = stats["branch_rows"]
    small = rows["small_scale"] / stats["n_patches"]
    print(f"{name}: of the {stats['n_patches']} served patches the small-scale branch takes "
          f"{small:.4f}, the large-scale one {1 - small:.4f}", flush=True)
    if min(rows.values()) == 0:
        fail(f"{name}: a branch served no patch: {rows}")


def check_dense_switching(data, testset, dense_dir, routed_dir) -> dict:
    """Phase 14a: the switching model served dense against its routed run
    of the same dtype, shape by shape: on the rows whose routed noise
    estimate lies SWITCH_GAP or more from the switch, the normals within
    BF16_ROUTED_RTOL of max |normal|; at most 2% of the rows left out."""
    import numpy as np

    from nestinet_tpu_torch.models.switching import NOISE_SWITCH_THRESHOLD as t

    with open(os.path.join(data, testset + ".txt")) as f:
        shapes = [s.strip() for s in f if s.strip()]
    diff = scale = 0.0
    rows = left_out = 0
    for shape in shapes:
        dense = np.loadtxt(os.path.join(dense_dir, shape + ".normals"), ndmin=2)
        routed = np.loadtxt(os.path.join(routed_dir, shape + ".normals"), ndmin=2)
        noise = np.loadtxt(os.path.join(routed_dir, shape + ".noise"), ndmin=1)
        keep = np.abs(noise.astype(np.float32) - np.float32(t)) >= SWITCH_GAP
        rows, left_out = rows + keep.size, left_out + int((~keep).sum())
        diff = max(diff, float(np.abs(dense[keep] - routed[keep]).max(initial=0.0)))
        scale = max(scale, float(np.abs(routed).max()))
    print(f"dense vs routed switching normals: max abs diff {diff:.3e} over {rows - left_out} "
          f"rows clear of the switch (max |normal| {scale:.3f}, rtol {BF16_ROUTED_RTOL}); "
          f"{left_out} rows at the switch left out", flush=True)
    if not diff <= BF16_ROUTED_RTOL * scale or left_out > 0.02 * rows:
        fail(f"dense and routed switching normals disagree: {diff} of {scale}, "
             f"{left_out} of {rows} rows left out")
    return {"max_abs_diff": diff, "max_abs_normal": scale, "left_out_at_switch": left_out}


def spread_noise_head(model, grid):
    """Rescale the switching model's noise head so that its estimates on one
    batch's grid are 0.015 + 0.01 N(0, 1)-like: half the patches take each
    branch.  Returns the small-scale branch's share on that batch after."""
    import torch

    from nestinet_tpu_torch.models.switching import NOISE_SWITCH_THRESHOLD

    net = model.noise
    with torch.inference_mode():
        h = net.backbone(grid.permute(0, 4, 1, 2, 3)[:, 20:])
        h = net.head.fc3(net.head.fc2(net.head.fc1(h)))
    last = net.head.fc4.linear
    with torch.no_grad():
        z = (h @ last.w.t())[:, 0]
        scale = 0.01 / z.std()
        last.w.mul_(scale)
        zs = (z * scale).sort().values  # the threshold between the two middle patches
        last.b.fill_(NOISE_SWITCH_THRESHOLD - float(zs[(len(zs) - 1) // 2:len(zs) // 2 + 1].mean()))
        noise = model.forward_grid(grid)["noise_pred"]
    return float((noise < NOISE_SWITCH_THRESHOLD).float().mean())


def make_ablation_run(tmp, data, model_name, grids, queries, radii, seed, caps, dev):
    """Phase 14a: a full-width run dir of one ablation model (its radii out
    of the flagship's, 512 points, 8^3 Gaussians, random weights and
    BatchNorm state from a seed; the switching model's noise head spread
    across the switch); returns (run path, cfg, the model's radii indices,
    the small branch's share on one batch or None, its int8 launches a
    batch, `int8_calls`)."""
    import torch

    from nestinet_tpu_torch.core import checkpoint
    from nestinet_tpu_torch.core.config import Config
    from nestinet_tpu_torch.core.rundir import RunDir
    from nestinet_tpu_torch.infer.device_pipeline import extract_batch
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    idx = ABLATION_RADII[model_name]
    cfg = Config(model=model_name, log_dir=os.path.join(tmp, f"run_{model_name}"),
                 data_path=data, patch_radius=tuple(FLAGSHIP_RADII[i] for i in idx),
                 num_point=512, num_gaussians=8, seed=SEED)
    rd = RunDir.create(cfg.log_dir)
    cfg.save(rd.config_path)
    gmm = get_3d_grid_gmm([8, 8, 8], variance=cfg.gmm_variance)
    gmm.save(rd.gmm_path)
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(cfg, gmm, gen)
    randomize_bn(model, gen)
    share = None
    if model_name == "ms_sw_n_est":
        model.to(dev).eval()
        with torch.inference_mode():
            points, n_eff = extract_batch([grids[i] for i in idx], queries,
                                          [radii[i] for i in idx], seed, num_point=512,
                                          caps=[caps[i] for i in idx])
            grid = model.mups_grid(points, n_eff)
        share = spread_noise_head(model, grid)
    checkpoint.save(rd.path, model.cpu().state_dict())
    n_params = sum(v.numel() for v in model.state_dict().values())
    print(f"run dir: {model_name}, radii {cfg.patch_radius}, {n_params} weights"
          + ("" if share is None else f"; the small-scale branch takes {share:.3f} of one "
             f"batch of {DEVICE_BATCH}, the large-scale one {1 - share:.3f}"), flush=True)
    return rd.path, cfg, idx, share, int8_calls(model)


def check_ablation_batch(run, cfg, idx, grids, queries, radii, seed, caps, dev):
    """Phase 14a: one device batch through the served model on the kernel
    and on the plain MuPS: normals (and the noise estimate) within
    NORMALS_ATOL in float32; the switching model's normals wherever both
    noise estimates lie on one side of the switch and SWITCH_GAP or more
    from it (the noise head was spread on this batch, so its middle
    patches sit at the switch), at most 2% of the batch left out; returns
    the errors."""
    import torch

    from nestinet_tpu_torch.infer.device_pipeline import extract_batch
    from nestinet_tpu_torch.infer.predict import load_run
    from nestinet_tpu_torch.ops import mups as mups_ops

    _, _, _, model = load_run(run, dev, "float32")
    with torch.inference_mode():
        points, n_eff = extract_batch([grids[i] for i in idx], queries, [radii[i] for i in idx],
                                      seed, num_point=512, caps=[caps[i] for i in idx])
        grid = model.mups_grid(points, n_eff)
    pools = {"forward": pool_launches(lambda: model.forward_grid(grid))}
    if cfg.model == "ms_sw_n_est":
        pools.update(gate=pool_launches(lambda: model.gate(grid)),
                     branch=pool_launches(lambda: model.expert_on_grid(0, grid)))
    want_pools = ABLATION_POOLS[cfg.model]
    print(f"{cfg.model}: the max pool kernel's launches {pools} (one a pool: {want_pools})",
          flush=True)
    if pools != want_pools:
        fail(f"{cfg.model}: the max pool kernel's launches {pools}, where the pools make "
             f"{want_pools}")
    with torch.inference_mode():
        out_k = model(points, n_eff)
        rows = mups_ops.tdmfv_n_est_reference(points.reshape(-1, 512, 3), model.gmm_w,
                                              model.gmm_mu, model.gmm_sigma, n_eff.reshape(-1))
        out_p = model.forward_grid(mups_ops.stats_to_grid(rows, DEVICE_BATCH, cfg.n_scales,
                                                          model.resolution))
        torch.cuda.synchronize()
    keep = torch.ones(DEVICE_BATCH, dtype=torch.bool, device=dev)
    if "noise_pred" in out_k:
        from nestinet_tpu_torch.models.switching import NOISE_SWITCH_THRESHOLD as t

        nk, np_ = out_k["noise_pred"], out_p["noise_pred"]
        keep = ((nk < t) == (np_ < t)) & ((nk - t).abs() >= SWITCH_GAP)
    errs = {k: (out_k[k] - out_p[k])[keep if k == "n_pred" else slice(None)].abs().max().item()
            for k in out_k}
    left_out = DEVICE_BATCH - int(keep.sum())
    print(f"{cfg.model}, one device batch vs plain MuPS: max abs err {errs} (atol "
          f"{NORMALS_ATOL}); {left_out} patches at the switch left out; max |normal| "
          f"{out_k['n_pred'].abs().max().item():.3f}", flush=True)
    if not all(e <= NORMALS_ATOL for e in errs.values()) or left_out > 0.02 * DEVICE_BATCH:
        fail(f"{cfg.model}: the kernel and the plain MuPS disagree: {errs}, {left_out} left out")
    errs["left_out_at_switch"] = left_out
    del model
    return errs


def ablation_train_args(model_name, data, sw_data, run):
    """Phase 14b: `cli.train` of one ablation model at full width, B = 256,
    ABLATION_EPOCHS of a few steps (the switching model on the switching
    benchmark)."""
    if model_name == "ms_sw_n_est":
        data, lists, pps = sw_data, ("trainingset_switching.txt",
                                     "validationset_switching.txt"), SWITCH_PATCHES_PER_SHAPE
    else:
        lists, pps = ("trainingset_whitenoise.txt", "validationset.txt"), TRAIN_PATCHES_PER_SHAPE
    radii = [str(FLAGSHIP_RADII[i]) for i in ABLATION_RADII[model_name]]
    return ["--model", model_name, "--data_path", data, "--log_dir", run,
            "--trainset", lists[0], "--testset", lists[1], "--patch_radius", *radii,
            "--num_point", "512", "--num_gaussians", "8", "--batch_size", "256",
            "--patches_per_shape", str(pps), "--seed", str(SEED),
            "--max_epoch", str(ABLATION_EPOCHS)]


def check_ablation_trained(model_name, run):
    """Phase 14b: ABLATION_EPOCHS train and eval epochs in metrics.jsonl with finite
    losses (the switching model's noise_loss too) and a finite validation
    RMS, the periodic checkpoint."""
    import json as _json

    import numpy as np

    from nestinet_tpu_torch.core import checkpoint

    with open(os.path.join(run, "metrics.jsonl")) as f:
        metrics = [_json.loads(line) for line in f]
    kinds = [m["kind"] for m in metrics]
    if kinds != ["train", "eval"] * ABLATION_EPOCHS or not checkpoint.exists(run):
        fail(f"{model_name}: the trained run holds {kinds}")
    keys = ("loss", "noise_loss") if model_name == "ms_sw_n_est" else ("loss",)
    if not all(np.isfinite(m[k]) for m in metrics if m["kind"] == "train" for k in keys):
        fail(f"{model_name}: non-finite {keys} in metrics.jsonl")
    if not all(np.isfinite(m["rms_deg"]) for m in metrics if m["kind"] == "eval"):
        fail(f"{model_name}: an epoch validated no batch")
    return [{k: m.get(k) for k in ("kind", "loss", "noise_loss", "rms_deg") if k in m}
            for m in metrics]


def check_jax_fixture(tmp):
    """Phase 14c: `cli.test` serves the committed run dir that the JAX
    package wrote (`nestinet_tpu_torch/testdata/jax_run_moe3/`, read by the
    flax-free reader) on the card in float32 with device extraction: the
    normals within NORMALS_ATOL of the ones JAX served on the CPU."""
    import shutil

    import numpy as np

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nestinet_tpu_torch",
                           "testdata", "jax_run_moe3")
    run, data = os.path.join(tmp, "jax_run"), os.path.join(tmp, "jax_run_data")
    shutil.copytree(os.path.join(fixture, "run"), run)
    shutil.copytree(os.path.join(fixture, "data"), data)
    secs = run_module("nestinet_tpu_torch.cli.test", "--results_path", run, "--dataset_path",
                      data, "--dataset_name", "card", "--compute_dtype", "float32",
                      "--extraction", "device", "--batch_size", "64", "--model",
                      "experts_n_est")
    out = {}
    for ext in (".normals", ".experts"):
        got = np.loadtxt(os.path.join(run, "card_results", "sphere400" + ext))
        want = np.loadtxt(os.path.join(fixture, "jax_normals", "sphere400" + ext))
        out[ext] = (got, want)
    got, want = out[".normals"]
    err = float(np.abs(got - want).max())
    same = float((out[".experts"][0] == out[".experts"][1]).mean())
    print(f"JAX run dir on the card: {got.shape[0]} normals, max abs err {err:.3e} against "
          f"JAX's on the CPU (atol {NORMALS_ATOL}), experts equal on {same:.3f}, "
          f"{secs:.1f} s", flush=True)
    if got.shape != want.shape or not err <= NORMALS_ATOL:
        fail(f"the JAX run dir served on the card differs from JAX's normals: {err}")
    return {"max_abs_err": err, "experts_equal": same, "seconds": secs}


def phase14(tmp, data, dev, grids, queries, radii, bseed, caps, run_gmm, kernels, card):
    """Phase 14: each ablation model served at full width from a seed (f32,
    bf16, and int8+fold for the single-scale model) on ABLATION_TESTSET, one
    device batch held against the plain MuPS, the f32 train step timed,
    `cli.train` for ABLATION_EPOCHS and `cli.test` of the trained run, then the
    JAX run dir served on the card; returns (per-model record, the JAX run
    dir's record)."""
    import torch

    from nestinet_tpu_torch.core.config import Config
    from nestinet_tpu_torch.data.synthetic import build_switching_benchmark
    from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device

    kernel = kernels[0]
    t14 = time.perf_counter()
    sw_data = os.path.join(tmp, "switching")
    sw_sets = build_switching_benchmark(sw_data, n_points=SWITCH_POINTS, n_pidx=100,
                                        seed=SEED % 1000)
    sw_two = [n for n in sw_sets["testset_switching.txt"]
              if n.endswith(("_sw000", "_sw030"))][:2]
    with open(os.path.join(sw_data, "testset_two.txt"), "w") as f:
        f.write("\n".join(sw_two) + "\n")
    test_data = {m: sw_data if m == "ms_sw_n_est" else data for m in ABLATION_RADII}
    ablations = {}
    for model_name in ABLATION_RADII:
        run, acfg, idx, share, int8_per = make_ablation_run(tmp, data, model_name, grids,
                                                            queries, radii, bseed, caps, dev)
        runs = {}
        for label, dtype, fold in ABLATION_DTYPES[model_name]:
            runs[label] = serve(f"{model_name} device {label}", lambda: predict_shapes_device(
                run, dataset_name=f"ablation_{label}", testset="testset_one.txt",
                data_path=data, batch_size=DEVICE_BATCH, compute_dtype=dtype,
                fold_bn=fold), kernels, card, int8=dtype == "int8", int8_per=int8_per)
            runs[label]["rms"] = check_outputs(data, runs[label]["output_dir"], "testset_one",
                                               ROUTED_BRANCHES.get(model_name))["rms"]
            check_branch_share(f"{model_name} device {label}", runs[label])
        if model_name in ABLATION_DENSE:
            label = ABLATION_DENSE[model_name]
            dtype, fold = next(d[1:] for d in ABLATION_DTYPES[model_name] if d[0] == label)
            runs[f"{label} dense"] = dense = serve(
                f"{model_name} device {label} dense", lambda: predict_shapes_device(
                    run, dataset_name=f"ablation_{label}_dense", testset="testset_one.txt",
                    data_path=data, batch_size=DEVICE_BATCH, compute_dtype=dtype,
                    fold_bn=fold, moe_inference="dense"), kernels, card)
            dense["rms"] = check_outputs(data, dense["output_dir"], "testset_one", None)["rms"]
            check_branch_share(f"{model_name} device {label} dense", dense)
            dense["routed_gap"] = check_dense_switching(
                data, "testset_one", dense["output_dir"], runs[label]["output_dir"])
        errs = check_ablation_batch(run, acfg, idx, grids, queries, radii, bseed, caps, dev)
        ablations[model_name] = {"radii": acfg.patch_radius, "serving": runs,
                                 "plain_mups_max_abs_err": errs,
                                 "small_branch_share_one_batch": share}
        print(f"evaluate {model_name}: RMS " + ", ".join(
            f"{k} {v['rms']:.4f} deg" for k, v in runs.items()) + " (random weights, one "
            "shape)", flush=True)
    torch.cuda.empty_cache()
    for model_name, idx in ABLATION_RADII.items():
        tcfg = Config(model=model_name, patch_radius=tuple(FLAGSHIP_RADII[i] for i in idx),
                      num_point=512, num_gaussians=8, seed=SEED)
        ablations[model_name]["train_step_f32"] = time_train_steps(
            dev, tcfg, run_gmm, "float32", kernel, card, steps=ABLATION_TRAIN_STEPS)
    # the three cli.train calls at once: their f32 step peaks sum to about half the card
    train_runs = {m: os.path.join(tmp, f"train_{m}") for m in ABLATION_RADII}
    for m, secs in zip(ABLATION_RADII, run_modules([
            ("nestinet_tpu_torch.cli.train", ablation_train_args(m, data, sw_data, train_runs[m]))
            for m in ABLATION_RADII])):
        ablations[m]["cli_train_seconds"] = secs
    test_secs = run_modules([("nestinet_tpu_torch.cli.test", [
        "--results_path", train_runs[m], "--dataset_path", test_data[m], "--testset",
        f"{ABLATION_TESTSET[m]}.txt", "--dataset_name", "trained", "--extraction", "device",
        "--batch_size", str(DEVICE_BATCH), "--model", m]) for m in ABLATION_RADII])
    for m, secs in zip(ABLATION_RADII, test_secs):
        ablations[m]["trained_metrics"] = check_ablation_trained(m, train_runs[m])
        ablations[m]["trained_rms"] = check_outputs(
            test_data[m], os.path.join(train_runs[m], "trained_results"),
            ABLATION_TESTSET[m], ROUTED_BRANCHES.get(m))["rms"]
        print(f"{m}: cli.train {ablations[m]['cli_train_seconds']:.1f} s ({ABLATION_EPOCHS} "
              f"epoch, the three at once), cli.test of the trained run {secs:.1f} s (device "
              f"extraction, bf16, {ABLATION_TESTSET[m]}): RMS "
              f"{ablations[m]['trained_rms']:.4f} deg; "
              f"metrics {ablations[m]['trained_metrics']}", flush=True)
    jax_fixture = check_jax_fixture(tmp)
    print(f"phase 14: the phase took {time.perf_counter() - t14:.1f} s", flush=True)
    return ablations, jax_fixture


# ---------------------------------------------------------------- phase 16

DP_RANKS = 2  # phase 16b: ranks sharing cuda:0 over gloo
DP_STEPS = 2  # the two-rank step: step 1 held to the one-process step, step 2 timed
DP_TIMEOUT = 900  # seconds a two-rank launch may take before its ranks are killed
# phase 17: the same two ranks as a 1 x 2 (data, expert) mesh; each holds the
# manager, 3 of the 6 one-scale experts (group 0) and the three-scale singleton
EP_RANKS = 2
EP_RANK_PARAMS = 117_552_877
EP_TRAIN_SHAPES = 9  # 17b's training list: 9 of 13c's 18 shapes, 2 steps of 256


# phase 18, the quality bar on the committed trained run dirs
# (`tests/test_torch_quality_fixture.py` writes them with JAX and holds the
# port to the same bars on the CPU)
QUALITY_RUN = os.path.join("nestinet_tpu_torch", "testdata", "jax_run_moe_trained")
SWITCH_RUN = os.path.join("nestinet_tpu_torch", "testdata", "jax_run_switching")
SWITCH_SYNTH = ["--switching", "--n_points", "5000", "--n_pidx", "200", "--seed", "23"]
QUALITY_BATCH = 256
QUALITY_F32_BAR_DEG = 0.01  # host-dense float32 against JAX's anchor, per testset
QUALITY_BAR_DEG = 0.1  # every other mode against the anchor, per testset
# each mode against JAX's same mode in anchor.json, per testset, from the
# readings (`tests/test_torch_quality_fixture.py::SAME_MODE_BAR_DEG`)
QUALITY_SAME_MODE_BAR_DEG = {
    "host-dense f32": 0.01,
    "device-sparse f32": 0.01,
    "device-sparse bf16": 0.01,
    "device-sparse bf16+fold": 0.01,
    "device-sparse int8": 0.01,
    "device-sparse int8+fold": 0.01,
}
SWITCH_NOISE_ATOL = 1e-4
SWITCH_RMS_ATOL_DEG = 0.01
LEARNED_K = 64  # phase 18c: the learned GMM's components
LEARNED_POINTS = 65536  # of the served rows' points, drawn from the seed


def _timed_mesh(mesh, seconds: list, gather_seconds: list | None = None):
    """`mesh` whose gradient all-reduce (`mean_gradients_`) and expert
    gather (`gather_experts`) record their wall seconds, the card
    synchronized around each."""
    import dataclasses

    import torch

    def timed(fn, out_seconds, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        out_seconds.append(time.perf_counter() - t0)
        return out

    class TimedMesh(type(mesh)):
        def mean_gradients_(self, *args):
            return timed(super().mean_gradients_, seconds, *args)

        def gather_experts(self, x):
            return timed(super().gather_experts, gather_seconds, x)

    return TimedMesh(*(getattr(mesh, f.name) for f in dataclasses.fields(mesh)))


def dp_step_rank(cfg, batch: dict, steps: int) -> dict | None:
    """Phases 16b and 17a on each rank of one two-rank launch: the
    data-parallel steps (`dp_rank_steps`), then the same ranks as a 1 x 2
    expert-parallel mesh (`ep_rank_steps`).  Rank 0 returns both."""
    import gc

    import torch

    dp = dp_rank_steps(cfg, batch, steps)
    gc.collect()
    torch.cuda.empty_cache()
    ep = ep_rank_steps(cfg, batch, steps)
    return None if dp is None else dict(dp, ep=ep)


def ep_rank_steps(cfg, batch: dict, steps: int) -> dict | None:
    """Phase 17a, on each rank: a 1 x 2 (data, expert) mesh, the full-width
    float32 model from the seed keeping this rank's experts
    (`train/mesh.py::shard_model`), every row of `batch` and `steps`
    expert-parallel train steps, each timed with the card synchronized, the
    expert gather and the gradient all-reduce apart.  Rank 0 returns step
    1's loss and its gradients and BatchNorm state gathered into the
    one-process layout, every rank's BatchNorm state, parameter count,
    MuPS launches and backward calls in step 1, step, gather and all-reduce
    times and peak memory."""
    import torch

    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
    from nestinet_tpu_torch.ops.kernels import mups_cuda
    from nestinet_tpu_torch.train.mesh import make_mesh, shard_model
    from nestinet_tpu_torch.train.train_step import make_optimizer, make_train_step

    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(1, EP_RANKS)
    reduce_s, gather_s = [], []
    timed = _timed_mesh(mesh, reduce_s, gather_s)
    gmm = get_3d_grid_gmm([cfg.num_gaussians] * 3, variance=cfg.gmm_variance)
    model = build_model(cfg, gmm, torch.Generator().manual_seed(SEED))
    shard_model(model, timed)
    model.to(dev)
    step_fn = make_train_step(model, cfg, make_optimizer(model, cfg), mesh=timed)
    local = {k: v.to(dev) for k, v in batch.items()}  # one data rank: every row
    torch.cuda.reset_peak_memory_stats()
    step_ms, out = [], {}
    for i in range(steps):
        mups_cuda.KERNEL.reset_launches()
        mups_ops.BACKWARD_CALLS["plain"] = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = step_fn(local, i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        if i == 0:
            out = {"loss": loss.item(), "launches": mups_cuda.KERNEL.launches["tdmfv_n_est"],
                   "backward_calls": mups_ops.BACKWARD_CALLS["plain"],
                   "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                             if mesh.is_main or model.is_shard_key(n)},
                   "buffers": {n: b.to("cpu", copy=True) for n, b in model.named_buffers()}}
    out.update(seconds=time.perf_counter() - t0, step_ms=step_ms,
               gather_ms=[1e3 * s for s in gather_s],
               allreduce_ms=[1e3 * s for s in reduce_s], coords=(mesh.rank, mesh.expert_rank),
               params=sum(p.numel() for p in model.parameters()),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    ranks = mesh.gather_experts_to_main(out)
    if not mesh.is_main:
        return None
    grads, buffers = {}, {}
    for r in ranks:
        grads.update(r.pop("grads"))
        buffers.update(r["buffers"])
    return {"loss": out["loss"], "grads": grads, "buffers": buffers,
            "rank_buffers": [r.pop("buffers") for r in ranks], "ranks": ranks}


def dp_rank_steps(cfg, batch: dict, steps: int) -> dict | None:
    """Phase 16b, on each rank: the full-width float32 model from the seed,
    global BatchNorm moments, this rank's rows of `batch` (CPU tensors), and
    `steps` data-parallel train steps, each timed with the card
    synchronized, the gradient all-reduce apart.  Rank 0 returns step 1's
    loss and gradients, every rank's BatchNorm state after the last step,
    and every rank's MuPS launches and backward calls in step 1, step
    times, all-reduce times and peak memory."""
    import torch

    from nestinet_tpu_torch.core.device import set_f32_numerics
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
    from nestinet_tpu_torch.ops.kernels import mups_cuda
    from nestinet_tpu_torch.ops.nn import set_moment_sum
    from nestinet_tpu_torch.train.mesh import make_mesh
    from nestinet_tpu_torch.train.train_step import make_optimizer, make_train_step

    set_f32_numerics()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(DP_RANKS)
    gmm = get_3d_grid_gmm([cfg.num_gaussians] * 3, variance=cfg.gmm_variance)
    model = build_model(cfg, gmm, torch.Generator().manual_seed(SEED)).to(dev)
    set_moment_sum(model, mesh.sum)
    reduce_s: list = []
    step_fn = make_train_step(model, cfg, make_optimizer(model, cfg),
                              mesh=_timed_mesh(mesh, reduce_s))
    rows = mesh.rows(batch["points"].shape[0])
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    step_ms, out = [], {}
    for i in range(steps):
        mups_cuda.KERNEL.reset_launches()
        mups_ops.BACKWARD_CALLS["plain"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step_fn(local, i)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            out = {"loss": loss.item(), "launches": mups_cuda.KERNEL.launches["tdmfv_n_est"],
                   "backward_calls": mups_ops.BACKWARD_CALLS["plain"]}
            if mesh.is_main:
                grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    mine = dict(out, step_ms=step_ms, allreduce_ms=[1e3 * s for s in reduce_s],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    ranks = mesh.gather_to_main(mine)
    buffers = mesh.gather_to_main({n: b.cpu() for n, b in model.named_buffers()})
    if not mesh.is_main:
        return None
    return {"loss": out["loss"], "grads": grads, "buffers": buffers, "ranks": ranks}


def plain_steps(dev, cfg, gmm, batch) -> dict:
    """Phase 16's one-process references: the plain full-width float32 step
    from the seed on `batch` (cuDNN's deterministic algorithms on) and the
    same step on the points moved by 1e-7 relative (the spread of 13a's
    bars), both on the card.  Returns the plain step's loss, weights,
    buffers and gradients and the perturbed step's gradients, on the CPU."""
    import torch

    from nestinet_tpu_torch.models import build_model

    torch.backends.cudnn.deterministic = True
    model = build_model(cfg, gmm, torch.Generator().manual_seed(SEED)).to(dev)
    loss, grads = step_gradients(model, cfg, batch)
    out = {"loss": loss, "grads": grads, "noisy": bn_fed_biases(model),
           "state": {n: t.cpu() for n, t in model.state_dict().items()}}
    torch.backends.cudnn.deterministic = False
    model = build_model(cfg, gmm, torch.Generator().manual_seed(SEED)).to(dev)
    out["spread_grads"] = step_gradients(model, cfg, perturbed(batch, TRAIN_PERTURB_REL,
                                                                  SEED))[1]
    del model
    torch.cuda.empty_cache()
    return out


def phase16a(dev, cfg, gmm, batch, plain, data, run, one_dir):
    """Phase 16a: an NCCL group of one rank in this process.  The
    full-width float32 train step at B = 256 through the data-parallel code
    (the group's gradient all-reduce) against the plain step from the same
    weights (`plain_steps`), and device-sparse float32 serving of one shape
    in the group against the one-process files of that shape
    (`one_process_refs`): both bit for bit (cuDNN's deterministic
    algorithms on for the steps)."""
    import torch
    import torch.distributed as dist

    from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.train import distributed
    from nestinet_tpu_torch.train.mesh import make_mesh
    from nestinet_tpu_torch.train.train_step import make_optimizer, make_train_step

    distributed.init_group(0, 1, f"127.0.0.1:{distributed.free_port()}", "nccl")
    try:
        mesh = make_mesh(1)
        model = build_model(cfg, gmm, torch.Generator().manual_seed(SEED)).to(dev)
        torch.backends.cudnn.deterministic = True
        loss = make_train_step(model, cfg, make_optimizer(model, cfg), mesh=mesh)(batch, 0)
        torch.backends.cudnn.deterministic = False
        differ = [n for n, t in model.state_dict().items()
                  if not torch.equal(t.cpu(), plain["state"][n])]
        differ += [n for n, p in model.named_parameters()
                   if not torch.equal(p.grad.cpu().double(), plain["grads"][n])]
        print(f"phase 16a: NCCL world of one [full width, f32, B={batch['points'].shape[0]}]: "
              f"loss {loss.item()!r} against the plain step's {plain['loss']!r}; {len(differ)} "
              f"weights, buffers or gradients differ", flush=True)
        if loss.item() != plain["loss"] or differ:
            fail(f"the data-parallel step of one rank differs from the plain step: {differ[:5]}")
        del model
        torch.cuda.empty_cache()
        stats = predict_shapes_device(run, dataset_name="pcpnet_dp1", testset="testset_one.txt",
                                      data_path=data, batch_size=DEVICE_BATCH,
                                      moe_inference="sparse", compute_dtype="float32")
        same = files_equal(stats["output_dir"], one_dir, stats["shapes"])
        print(f"phase 16a: routed f32 serving in the group, {stats['n_patches']} patches"
              f"{routing_line(stats)}: files identical to one process's {same}", flush=True)
        if not same:
            fail("routed serving in a group of one differs from one process's files")
    finally:
        dist.destroy_process_group()
    return {"loss": loss.item(), "serving_patches": stats["n_patches"]}


def files_equal(out_dir, ref_dir, shapes, exts=(".normals", ".experts", ".experts_probs")):
    """True when every `<shape><ext>` of `out_dir` equals `ref_dir`'s byte for byte."""
    for shape in shapes:
        for ext in exts:
            with open(os.path.join(out_dir, shape + ext), "rb") as a, open(
                    os.path.join(ref_dir, shape + ext), "rb") as b:
                if a.read() != b.read():
                    return False
    return True


def phase16b_step(dev, cfg, batch, plain, card):
    """Phase 16b: two ranks on cuda:0 over gloo take the B = 256 step, 128
    rows each, against the one-process step (`plain_steps`) at phase 13a's
    bars: the loss at rtol 1e-5, each gradient tensor within 4x the worst
    tensor's spread and all of them within 4x the whole spread, the spread
    being what moving the points by 1e-7 relative does to the one-process
    step on the card; the BN-fed biases within 1e-4 of their kernel's
    gradient norm.  The BatchNorm state equal on both ranks, one MuPS
    launch and no plain backward call per rank a step."""
    import torch

    from nestinet_tpu_torch.train import distributed

    ref, noisy, plain_loss = plain["grads"], plain["noisy"], plain["loss"]
    spread = gradient_errors(plain["spread_grads"], ref, noisy)
    free, total = torch.cuda.mem_get_info()
    print(f"phase 16b: before the launch this process holds "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB; the card has {free / 1e9:.1f} of "
          f"{total / 1e9:.1f} GB free", flush=True)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    got = distributed.launch(dp_step_rank, DP_RANKS, (cfg, cpu_batch, DP_STEPS), device="cuda",
                             backend="gloo", timeout=DP_TIMEOUT)
    secs = time.perf_counter() - t0
    errs = gradient_errors({n: g.double() for n, g in got["grads"].items()}, ref, noisy)
    tensor_bar = max(TRAIN_GRAD_SPREADS * spread["worst"][1], 1e-4)
    all_bar = max(TRAIN_GRAD_SPREADS * spread["all"], 1e-4)
    loss_err = abs(got["loss"] - plain_loss) / abs(plain_loss)
    first, second = got["buffers"]
    bn_equal = all(torch.equal(first[n], second[n]) for n in first)
    ranks = got["ranks"]
    step_ms = [sorted(r["step_ms"][1:])[len(r["step_ms"][1:]) // 2] for r in ranks]
    reduce_ms = [sorted(r["allreduce_ms"][1:])[len(r["allreduce_ms"][1:]) // 2] for r in ranks]
    print(f"phase 16b: {DP_RANKS} ranks on one card over gloo [full width, f32, B="
          f"{batch['points'].shape[0]}, {batch['points'].shape[0] // DP_RANKS} a rank]: loss "
          f"{got['loss']:.6f} vs one process {plain_loss:.6f} (rel err {loss_err:.2e}); "
          f"gradients, relative L2: worst tensor {errs['worst'][1]:.2e} ({errs['worst'][0]}), "
          f"all {errs['all']:.2e}; the spread at points moved by {TRAIN_PERTURB_REL:g}: worst "
          f"{spread['worst'][1]:.2e}, all {spread['all']:.2e}; bars {tensor_bar:.2e} and "
          f"{all_bar:.2e}; BN-fed biases {errs['bias']:.2e}; BN state equal on both ranks "
          f"{bn_equal}; MuPS launches in step 1 per rank {[r['launches'] for r in ranks]}, "
          f"backward calls {[r['backward_calls'] for r in ranks]}", flush=True)
    shares = [round(100 * a / s, 1) for a, s in zip(reduce_ms, step_ms)]
    peaks = [round(r["peak_memory_gb"], 2) for r in ranks]
    print(f"time: the two-rank step {step_ms} ms per rank (the steps after the first), "
          f"gradient all-reduce {reduce_ms} ms ({shares}% of the step), peak {peaks} GB a rank; "
          f"the launch took {secs:.1f} s [{card}]", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        fail(f"the two-rank step's loss differs from one process's: {loss_err}")
    if not (errs["worst"][1] <= tensor_bar and errs["all"] <= all_bar
            and errs["bias"] <= TRAIN_BIAS_RTOL):
        fail(f"the two-rank step's gradients differ from one process's: {errs['worst']}, "
             f"all {errs['all']}, biases {errs['bias']}")
    if not bn_equal:
        fail("the BatchNorm state differs between the two ranks")
    if any(r["launches"] != 1 or r["backward_calls"] != 0 for r in ranks):
        fail(f"the two-rank step: MuPS launches or backward calls per rank {ranks}")
    return {"loss_rel_err": loss_err, "grad_worst": errs["worst"], "grad_all": errs["all"],
            "spread_worst": spread["worst"], "spread_all": spread["all"],
            "bn_fed_bias_grad_err": errs["bias"], "step_ms": step_ms, "allreduce_ms": reduce_ms,
            "ranks": ranks, "launch_seconds": secs, "ep": got["ep"]}


def phase16b_cli(data, run, dev_sparse, int8_fold, kernels, card, int8_per):
    """Phase 16b: `cli.train --data_parallel 2 --backend gloo` for one epoch
    of 13c's sets, then `cli.test --data_parallel 2 --backend gloo` with
    device extraction on two shapes in float32 (ids identical to phase 7's,
    normals within 1e-4) and on one in int8 with BatchNorm folded (files
    identical to one process's, `one_process_refs`); each rank's batches,
    expert runs and launches (the int8 kernel's as its batches and runs
    make)."""
    import numpy as np
    import torch

    from nestinet_tpu_torch.cli import test as cli_test
    from nestinet_tpu_torch.core import checkpoint

    train_run = os.path.join(os.path.dirname(run), "train_run_dp2")
    train_s = train_cli(data, train_run, "--max_epoch", "1", "--data_parallel", str(DP_RANKS),
                        "--backend", "gloo")
    with open(os.path.join(train_run, "metrics.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    periodic = checkpoint.load(train_run, torch.device("cpu"))
    print(f"phase 16b: cli.train --data_parallel {DP_RANKS}, one epoch: metrics {kinds}, "
          f"checkpoint epoch {periodic['epoch']} step {periodic['step']}, {train_s:.1f} s",
          flush=True)
    if kinds != ["train", "eval"] or periodic["epoch"] != 0 or os.path.exists(
            os.path.join(train_run, "1")):
        fail(f"cli.train --data_parallel {DP_RANKS}: the run holds {kinds}")
    out = {"cli_train_seconds": train_s}
    for label, dtype, fold, ref, testset in (
            ("f32", "float32", "0", dev_sparse, "testset_two.txt"),
            ("int8+fold", "int8", "1", int8_fold, "testset_one.txt")):
        for k in kernels:
            k.reset_launches()
        t0 = time.perf_counter()
        stats = cli_test.main([
            "--results_path", run, "--dataset_path", data, "--testset", testset,
            "--dataset_name", f"dp{DP_RANKS}_{dtype}", "--extraction", "device",
            "--batch_size", str(DEVICE_BATCH), "--compute_dtype", dtype, "--fold_bn", fold,
            "--data_parallel", str(DP_RANKS), "--backend", "gloo"], timeout=DP_TIMEOUT)
        secs = time.perf_counter() - t0
        ranks = stats["per_rank"]
        if label == "f32":
            got = {s: [np.loadtxt(os.path.join(d, s + ext)) for d in
                       (stats["output_dir"], ref["output_dir"]) for ext in (".experts", ".normals")]
                   for s in stats["shapes"]}
            ids = all(np.array_equal(g[0], g[2]) for g in got.values())
            err = max(float(np.abs(g[1] - g[3]).max()) for g in got.values())
            same = ids and err <= NORMALS_ATOL
            check = f"ids identical to phase 7's {ids}, normals max abs err {err:.2e}"
        else:
            same = files_equal(stats["output_dir"], ref["output_dir"], stats["shapes"])
            check = f"files identical to one process's int8+fold run {same}"
        print(f"phase 16b: cli.test --data_parallel {DP_RANKS} device-sparse {label}: "
              f"{stats['n_patches']} patches, {stats['patches_per_sec']:.1f} patches/s "
              f"({stats['seconds']:.1f} s serving, {secs:.1f} s with start-up); per rank "
              f"patches {[r['n_patches'] for r in ranks]}, batches "
              f"{[r['n_batches'] for r in ranks]}, expert runs "
              f"{[r['expert_runs'] for r in ranks]} of {stats['expert_runs']} "
              f"({stats['forced_flushes']} forced flushes, window {stats['window_slots']} "
              f"slots), launches {[r['launches'] for r in ranks]}; {check} [{card}]",
              flush=True)
        if not same:
            fail(f"cli.test --data_parallel {DP_RANKS} {label}: {check}")
        if sum(r["expert_runs"] for r in ranks) != stats["expert_runs"]:
            fail(f"cli.test --data_parallel {DP_RANKS} {label}: the ranks ran "
                 f"{[r['expert_runs'] for r in ranks]} of {stats['expert_runs']} expert runs")
        for r in ranks:
            if r["launches"]["tdmfv_n_est"] != r["n_batches"] or (
                    (int8_launches(r["launches"]) > 0) != (dtype == "int8")):
                fail(f"cli.test --data_parallel {DP_RANKS} {label}: rank launches {r}")
            if dtype == "int8":
                check_int8_launches(f"cli.test --data_parallel {DP_RANKS} {label}, a rank",
                                    r["launches"], r["n_batches"], r["expert_runs"], int8_per)
        if any(k.launches[n] for k in kernels for n in k.launches):
            fail("the two-rank serving launched a kernel in this process")
        out[label] = {k: v for k, v in stats.items() if k != "shapes"} | {
            "seconds_with_start_up": secs}
    return out


def dp_launches(dp: dict, kernel: str) -> dict:
    """Phase 16b's launches of `kernel` per rank: in the first train step
    (the MuPS kernel) and in each `cli.test --data_parallel` run."""
    out = {f"cli_test_{label}_per_rank": [r["launches"][kernel] for r in dp[label]["per_rank"]]
           for label in ("f32", "int8+fold")}
    if kernel == "tdmfv_n_est":
        out["train_step_per_rank"] = [r["launches"] for r in dp["step"]["ranks"]]
    return out


def phase17a(ep: dict, plain: dict, card) -> dict:
    """Phase 17a: the expert-parallel step that phase 16b's two ranks took
    as a 1 x 2 mesh (`ep_rank_steps`) against the one-process step
    (`plain_steps`) at phase 13a's bars: the loss at rtol 1e-5, the
    gradients gathered into the one-process layout within 4x the spread of
    points moved by 1e-7 (each tensor and all of them), the BN-fed biases
    within 1e-4 of their kernel's gradient norm, the BatchNorm state at atol
    1e-5 and equal on both ranks where both hold it; each rank holds
    EP_RANK_PARAMS parameters and launches MuPS once a step, with no plain
    backward call."""
    import torch

    ref, noisy = plain["grads"], plain["noisy"]
    spread = gradient_errors(plain["spread_grads"], ref, noisy)
    errs = gradient_errors({n: g.double() for n, g in ep["grads"].items()}, ref, noisy)
    tensor_bar = max(TRAIN_GRAD_SPREADS * spread["worst"][1], 1e-4)
    all_bar = max(TRAIN_GRAD_SPREADS * spread["all"], 1e-4)
    loss_err = abs(ep["loss"] - plain["loss"]) / abs(plain["loss"])
    state_buffers = [n for n in plain["state"] if n not in ref]  # the BatchNorm state
    if any(n not in ep["buffers"] for n in state_buffers):
        fail("the expert ranks' BatchNorm state misses some of the one-process model's")
    bn_err = max((ep["buffers"][n] - plain["state"][n]).abs().max().item()
                 for n in state_buffers)
    first, second = ep["rank_buffers"]
    bn_equal = all(torch.equal(first[n], second[n]) for n in first if n in second)
    ranks = ep["ranks"]

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    step_ms = [median(r["step_ms"][1:]) for r in ranks]
    gather_ms = [median(r["gather_ms"]) for r in ranks]
    reduce_ms = [median(r["allreduce_ms"][1:]) for r in ranks]
    peaks = [round(r["peak_memory_gb"], 2) for r in ranks]
    print(f"phase 17a: {EP_RANKS} expert ranks on one card over gloo [full width, f32, "
          f"B={TRAIN_BATCHES[0]} on each rank, ranks at (data, expert) "
          f"{[r['coords'] for r in ranks]}]: parameters a rank {[r['params'] for r in ranks]} "
          f"(want {EP_RANK_PARAMS}); loss {ep['loss']:.6f} vs one process "
          f"{plain['loss']:.6f} (rel err {loss_err:.2e}); gradients in the one-process layout, "
          f"relative L2: worst tensor {errs['worst'][1]:.2e} ({errs['worst'][0]}), all "
          f"{errs['all']:.2e}; bars {tensor_bar:.2e} and {all_bar:.2e}; BN-fed biases "
          f"{errs['bias']:.2e}; BN state max abs err {bn_err:.2e}, equal on both ranks where "
          f"both hold it {bn_equal}; MuPS launches in step 1 per rank "
          f"{[r['launches'] for r in ranks]}, backward calls "
          f"{[r['backward_calls'] for r in ranks]}", flush=True)
    print(f"time: the expert-parallel step {step_ms} ms per rank (the steps after the "
          f"first), the expert gather {gather_ms} ms a forward, the gradient all-reduce "
          f"{reduce_ms} ms; peak {peaks} GB a rank (phase 16b: 128 rows a rank) [{card}]",
          flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        fail(f"the expert-parallel step's loss differs from one process's: {loss_err}")
    if not (errs["worst"][1] <= tensor_bar and errs["all"] <= all_bar
            and errs["bias"] <= TRAIN_BIAS_RTOL):
        fail(f"the expert-parallel step's gradients differ from one process's: "
             f"{errs['worst']}, all {errs['all']}, biases {errs['bias']}")
    if not (bn_err <= TRAIN_BN_ATOL and bn_equal):
        fail(f"the expert-parallel BatchNorm state: max abs err {bn_err}, equal {bn_equal}")
    if any(r["params"] != EP_RANK_PARAMS for r in ranks):
        fail(f"parameters a rank {[r['params'] for r in ranks]}, want {EP_RANK_PARAMS}")
    if any(r["launches"] != 1 or r["backward_calls"] != 0 for r in ranks):
        fail(f"the expert-parallel step: MuPS launches or backward calls per rank {ranks}")
    return {"loss_rel_err": loss_err, "grad_worst": errs["worst"], "grad_all": errs["all"],
            "bn_fed_bias_grad_err": errs["bias"], "bn_max_abs_err": bn_err,
            "step_ms": step_ms, "gather_ms": gather_ms, "allreduce_ms": reduce_ms,
            "peak_memory_gb": peaks, "ranks": ranks}


def phase17b(tmp, data, one_process_run, kernels, card) -> dict:
    """Phase 17b: `cli.train --expert_parallel 2 --backend gloo` for one
    epoch on 9 of 13c's 18 training shapes (2 steps of 256) and 13c's
    validation set; its checkpoint holds the one-process layout (the keys
    and shapes of phase 13c's one-process run, an optimizer state for every
    parameter); `cli.test` serves it once (device-sparse f32, one shape)."""
    import torch

    from nestinet_tpu_torch.cli import test as cli_test
    from nestinet_tpu_torch.core import checkpoint

    with open(os.path.join(data, "trainingset_whitenoise.txt")) as f:
        shapes = f.read().split()
    with open(os.path.join(data, "trainingset_ep.txt"), "w") as f:
        f.write("\n".join(shapes[:EP_TRAIN_SHAPES]) + "\n")
    run = os.path.join(tmp, "train_run_ep2")
    train_s = train_cli(data, run, "--max_epoch", "1", "--expert_parallel", str(EP_RANKS),
                        "--backend", "gloo", "--trainset", "trainingset_ep.txt")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    got = checkpoint.load(run, torch.device("cpu"))
    want = checkpoint.load(one_process_run, torch.device("cpu"))
    same_layout = (
        {k: v.shape for k, v in got["state_dict"].items()}
        == {k: v.shape for k, v in want["state_dict"].items()}
        and {i: {k: v.shape for k, v in st.items()} for i, st in got["optimizer"]["state"].items()}
        == {i: {k: v.shape for k, v in st.items()} for i, st in want["optimizer"]["state"].items()}
        and got["optimizer"]["param_groups"][0]["params"]
        == want["optimizer"]["param_groups"][0]["params"])
    print(f"phase 17b: cli.train --expert_parallel {EP_RANKS}, one epoch: metrics {kinds}, "
          f"checkpoint epoch {got['epoch']} step {got['step']}, {len(got['state_dict'])} "
          f"entries, the one-process layout {same_layout}, {train_s:.1f} s", flush=True)
    if kinds != ["train", "eval"] or (got["epoch"], got["step"]) != (0, 2) or not same_layout:
        fail(f"cli.train --expert_parallel {EP_RANKS}: the run holds {kinds}, epoch "
             f"{got['epoch']} step {got['step']}, one-process layout {same_layout}")
    for k in kernels:
        k.reset_launches()
    t0 = time.perf_counter()
    stats = cli_test.main([
        "--results_path", run, "--dataset_path", data, "--testset", "testset_one.txt",
        "--dataset_name", "ep2", "--extraction", "device", "--batch_size", str(DEVICE_BATCH),
        "--compute_dtype", "float32"])
    secs = time.perf_counter() - t0
    launches = {n: k.launches[n] for k in kernels for n in k.launches}
    summary = check_outputs(data, stats["output_dir"], "testset_one", N_EXPERTS)
    print(f"phase 17b: cli.test of the expert-parallel run, device-sparse f32: "
          f"{stats['n_patches']} patches in {stats['n_batches']} batches, "
          f"{stats['patches_per_sec']:.1f} patches/s, RMS {summary['rms']:.4f} deg, launches "
          f"{launches}, {secs:.1f} s [{card}]", flush=True)
    if launches["tdmfv_n_est"] != stats["n_batches"]:
        fail(f"cli.test of the expert-parallel run: launches {launches}")
    return {"cli_train_seconds": train_s, "cli_test_seconds": secs,
            "cli_test_launches": launches, "cli_test_patches_per_sec": stats["patches_per_sec"],
            "cli_test_rms": summary["rms"]}


def one_process_refs(data, run, kernels, card, int8_per) -> dict:
    """Phase 16's one-process serving of `testset_one`, which the group
    serves: device-sparse float32 (16a) and int8+fold (16b).  Routed, an
    expert run holds rows of several batches and shapes, so a one-shape
    call's files are not phase 7's or 10's."""
    from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device

    return {label: serve(f"phase 16 one process, device-sparse {label}, one shape",
                         lambda: predict_shapes_device(
                             run, dataset_name=f"pcpnet_one_{dtype}_fold{int(fold)}",
                             testset="testset_one.txt", data_path=data,
                             batch_size=DEVICE_BATCH, moe_inference="sparse",
                             compute_dtype=dtype, fold_bn=fold),
                         kernels, card, int8=dtype == "int8", int8_per=int8_per)
            for label, dtype, fold in (("f32", "float32", False), ("int8+fold", "int8", True))}


def phase16(tmp, data, dev, cfg, gmm, run, dev_sparse, kernels, card, int8_per):
    """Phase 16: data parallelism (`train/distributed.py`, `train/mesh.py`)
    on the one card: the one-process references, (b) the two-rank step
    (launched before this process joins any group; the same launch takes
    phase 17a's expert-parallel step), (a) an NCCL world of one, (b)
    cli.train and cli.test on two ranks.  Returns phase 16's record and
    phase 17a's."""
    import torch

    t16 = time.perf_counter()
    refs = one_process_refs(data, run, kernels, card, int8_per)
    batch = training_batch(dev, TRAIN_BATCHES[0], SEED + 2, cfg.patch_radius)
    plain = plain_steps(dev, cfg, gmm, batch)
    record = {"step": phase16b_step(dev, cfg, batch, plain, card)}
    ep_step = phase17a(record["step"].pop("ep"), plain, card)
    record["world_of_one"] = phase16a(dev, cfg, gmm, batch, plain, data, run,
                                      refs["f32"]["output_dir"])
    del plain, batch
    torch.cuda.empty_cache()
    record |= phase16b_cli(data, run, dev_sparse, refs["int8+fold"], kernels, card, int8_per)
    print(f"phase 16: the phase took {time.perf_counter() - t16:.1f} s (with phase 17a's "
          f"steps in its two-rank launch)", flush=True)
    return record, ep_step


# ---------------------------------------------------------------- phase 18

def _quiet(fn, *args):
    """fn(*args) with its standard output kept (returned beside)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn(*args)
    return got, out.getvalue()


def _launch_counts(kernels) -> dict:
    return {n: k.launches[n] for k in kernels for n in k.launches}


def phase18a(tmp, root, kernels, card) -> dict:
    """Phase 18a: the port's `cli.synth` writes the committed MoE run dir's
    protocol sets (`anchor.json`'s `synth`); `scripts/run_quality.py`
    serves its copy on the card in the six modes of `anchor.json`, each
    with the launch counts set to 0 before and read after: per testset the
    host-dense float32 RMS within 0.01 deg of JAX's anchor, every other mode
    within 0.1 deg of it and within QUALITY_SAME_MODE_BAR_DEG of JAX's same
    mode; MuPS launched once a served batch; the int8 kernel in the int8
    modes only, as often as their batches and expert runs make."""
    from nestinet_tpu_torch.cli import synth
    from nestinet_tpu_torch.core.config import Config
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops.gmm import GridGMM
    from nestinet_tpu_torch.scripts import run_quality

    with open(os.path.join(root, QUALITY_RUN, "anchor.json")) as f:
        anchor = json.load(f)
    data, run = os.path.join(tmp, "quality_data"), os.path.join(tmp, "quality_run")
    _quiet(synth.main, ["--root", data, *anchor["synth"]])
    shutil.copytree(os.path.join(root, QUALITY_RUN, "run"), run)
    int8_per = int8_calls(build_model(Config.load(os.path.join(run, "config.json")),
                                      GridGMM.load(os.path.join(run, "gmm.json"))))
    want = anchor["modes"][anchor["anchor"]]
    modes = {}
    for i, (mode, flags) in enumerate(anchor["mode_flags"].items()):
        for k in kernels:
            k.reset_launches()
        t0 = time.perf_counter()
        got, _ = _quiet(run_quality.main, [run, "--data", data, "--batch", str(QUALITY_BATCH),
                                           "--results_name", f"q{i}", "--device", "cuda", *flags])
        secs = time.perf_counter() - t0
        launches = _launch_counts(kernels)
        stats = got["stats"].values()
        batches = sum(st["n_batches"] for st in stats)
        patches = sum(st["n_patches"] for st in stats)
        serve_s = sum(st["seconds"] for st in stats)
        routing = {k: sum(st[k] for st in stats) for k in ("expert_runs", "forced_flushes")
                   if all(k in st for st in stats)}
        rms = {ts: v["rms"] for ts, v in got["summary"].items()}
        gaps = {ts: rms[ts] - want[ts]["rms"] for ts in want}
        same = {ts: rms[ts] - v["rms"] for ts, v in anchor["modes"][mode].items()}
        bar = QUALITY_F32_BAR_DEG if mode == anchor["anchor"] else QUALITY_BAR_DEG
        same_bar = QUALITY_SAME_MODE_BAR_DEG[mode]
        modes[mode] = {"rms": rms, "gap_to_anchor": gaps, "gap_to_jax_same_mode": same,
                       "jax_rms": {ts: v["rms"] for ts, v in anchor["modes"][mode].items()},
            "pgp5": {ts: v["pgp5"] for ts, v in got["summary"].items()},
            "pgp10": {ts: v["pgp10"] for ts, v in got["summary"].items()},
            "patches": patches, "batches": batches, "patches_per_sec": patches / serve_s,
            "seconds": secs, "launches": launches, **routing}
        print(f"phase 18a: run_quality {mode}: RMS " + ", ".join(
            f"{ts} {v:.4f}" for ts, v in rms.items()) + f" deg; max |gap to the anchor| "
            f"{max(abs(g) for g in gaps.values()):.5f} deg (bar {bar}), to JAX's same mode "
            f"{max(abs(g) for g in same.values()):.5f} deg (bar {same_bar}); {patches} patches in "
            f"{batches} batches, {patches / serve_s:.1f} patches/s, launches {launches}, "
            f"routing {routing}, {secs:.1f} s [{card}]", flush=True)
        if not max(abs(g) for g in gaps.values()) <= bar:
            fail(f"phase 18a {mode}: RMS off JAX's anchor by {gaps} (bar {bar} deg)")
        if not max(abs(g) for g in same.values()) <= same_bar:
            fail(f"phase 18a {mode}: RMS off JAX's same mode by {same} (bar {same_bar} deg)")
        if launches["tdmfv_n_est"] != batches:
            fail(f"phase 18a {mode}: {launches['tdmfv_n_est']} MuPS launches for {batches} "
                 f"batches")
        if ("int8" in mode) != (int8_launches(launches) > 0):
            fail(f"phase 18a {mode}: int8 kernel launches {int8_launches(launches)}")
        if "int8" in mode:
            check_int8_launches(f"phase 18a {mode}", launches, batches, routing["expert_runs"],
                                int8_per)
    return modes


def phase18b(tmp, root, kernels, card) -> dict:
    """Phase 18b: `scripts/switching_demo.py` on a copy of the committed
    switching run dir (both packages serve it with `SW_BACKBONE` narrowed
    to `TINY`), on the card, against JAX's committed table: per noise level
    the small-branch share within one patch, the mean predicted noise
    within 1e-4, the RMS within 0.01 deg; MuPS launched once a batch."""
    from nestinet_tpu_torch.cli import synth
    from nestinet_tpu_torch.models import backbones
    from nestinet_tpu_torch.scripts import switching_demo

    with open(os.path.join(root, SWITCH_RUN, "jax_switching_demo.txt")) as f:
        want = json.loads(f.read().strip().splitlines()[-1])
    data, run = os.path.join(tmp, "switch_data"), os.path.join(tmp, "switch_run")
    _quiet(synth.main, ["--root", data, *SWITCH_SYNTH])
    shutil.copytree(os.path.join(root, SWITCH_RUN, "run"), run)
    saved, backbones.SW_BACKBONE = backbones.SW_BACKBONE, backbones.TINY
    try:
        for k in kernels:
            k.reset_launches()
        got, _ = _quiet(switching_demo.main, [run, "--data", data, "--device", "cuda"])
        launches = _launch_counts(kernels)
    finally:
        backbones.SW_BACKBONE = saved
    batches = -(-got["n_patches"] // 256)
    worst = {"share_patches": 0.0, "noise": 0.0, "rms": 0.0}
    for sigma, w in want["per_sigma"].items():
        g, n = got["per_sigma"][sigma], got["patches_per_sigma"][sigma]
        worst["share_patches"] = max(worst["share_patches"],
                                     abs(g["small_branch_frac"] - w["small_branch_frac"]) * n)
        worst["noise"] = max(worst["noise"], abs(g["mean_noise_pred"] - w["mean_noise_pred"]))
        worst["rms"] = max(worst["rms"], abs(g["rms_deg"] - w["rms_deg"]))
    print(f"phase 18b: switching_demo, {got['n_patches']} patches: small-branch share "
          f"{got['small_branch_share']:.4f} (JAX {want['small_branch_share']:.4f}), RMS "
          f"{got['rms_deg']:.4f} deg (JAX {want['rms_deg']:.4f}); per noise level the worst "
          f"share gap {worst['share_patches']:.2f} patches, mean noise {worst['noise']:.2e}, "
          f"RMS {worst['rms']:.2e} deg; launches {launches}, {got['seconds']:.2f} s of "
          f"serving [{card}]", flush=True)
    if not (worst["share_patches"] <= 1 + 1e-9 and worst["noise"] <= SWITCH_NOISE_ATOL
            and worst["rms"] <= SWITCH_RMS_ATOL_DEG and got["n_patches"] == want["n_patches"]):
        fail(f"phase 18b: switching_demo departs from JAX's table: {worst}")
    if launches["tdmfv_n_est"] != batches:
        fail(f"phase 18b: {launches['tdmfv_n_est']} MuPS launches for {batches} batches")
    return {"worst": worst, "launches": launches, "small_branch_share":
            got["small_branch_share"], "rms_deg": got["rms_deg"], "seconds": got["seconds"]}


def phase18c(dev, card) -> dict:
    """Phase 18c: the port's EM (`ops/gmm.py::get_learned_gmm`, seeded) fits
    a K = 64 diagonal GMM to 65,536 of the served rows' points (phase 4's
    768 rows at PCPNet's density); both MuPS kernels run on its unequal
    weights and anisotropic sigmas against the plain version at atol 1e-5,
    the blocked one identical to kernel 1 at every block_b."""
    import numpy as np
    import torch

    from nestinet_tpu_torch.core.device import cuda_median_ms
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.gmm import get_learned_gmm
    from nestinet_tpu_torch.ops.kernels import mups_cuda
    from nestinet_tpu_torch.scripts.mups_kernel_parts import served_rows

    with torch.inference_mode():
        pts, n_eff = served_rows(dev, SEED)
    real = pts[torch.arange(pts.shape[1], device=dev)[None, :] < n_eff[:, None]]
    real = real.cpu().numpy().astype(np.float64)
    rng = np.random.default_rng(SEED)
    sample = real[rng.choice(len(real), min(LEARNED_POINTS, len(real)), replace=False)]
    t0 = time.perf_counter()
    learned = get_learned_gmm(sample, LEARNED_K, seed=SEED)
    fit_s = time.perf_counter() - t0
    gmm_t = tuple(torch.from_numpy(a).to(dev) for a in learned.astuple())
    with torch.inference_mode():
        out = mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, n_eff)
        plain = mups_ops.tdmfv_n_est_reference(pts, *gmm_t, n_eff)
        err = (out - plain).abs().max().item()
        diffs = {bb: (mups_cuda.tdmfv_n_est_blocked_cuda(pts, *gmm_t, n_eff, bb) - out)
                 .abs().max().item() for bb in BLOCKS}
        ms = cuda_median_ms(lambda: mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, n_eff))
        plain_ms = cuda_median_ms(lambda: mups_ops.tdmfv_n_est_reference(pts, *gmm_t, n_eff),
                                  warmup=1, iters=5)
    sig = learned.sigma
    print(f"phase 18c: learned GMM, K = {LEARNED_K}, fitted to {len(sample)} of the "
          f"{len(real)} served points in {fit_s:.2f} s: weights {learned.weights.min():.4f}-"
          f"{learned.weights.max():.4f}, sigma {sig.min():.4f}-{sig.max():.4f} (per-axis "
          f"ratio up to {(sig.max(1) / sig.min(1)).max():.2f}); MuPS kernel 1 max abs err "
          f"{err:.2e} (atol {KERNEL_ATOL}), blocked minus kernel 1 {diffs}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms per {pts.shape[0]} rows [{card}]", flush=True)
    if not err <= KERNEL_ATOL:
        fail(f"phase 18c: MuPS kernel 1 on the learned GMM differs from the plain version: "
             f"{err}")
    if any(d != 0 for d in diffs.values()):
        fail(f"phase 18c: the blocked kernel differs from kernel 1 on the learned GMM: {diffs}")
    return {"fit_seconds": fit_s, "points": len(sample), "max_abs_err": err,
            "blocked_diff": diffs, "ms": ms, "plain_ms": plain_ms}


def phase18d(tmp, data, run, kernels, card, int8_per) -> dict:
    """Phase 18d: the two quality scripts at full width on random weights.
    `run_quality` serves phase 7's run dir in device-sparse int8+fold, each
    of the six testsets cut to its first shape (a data dir of links to
    phase 7's files); `switching_demo` serves phase 14a's `ms_sw_n_est` run
    dir (full `SW_BACKBONE`) on phase 14's two switching shapes.  Each with
    the launch counts set to 0 before and read after: MuPS launched once a
    batch, the int8 kernel in `run_quality` as often as its batches and
    expert runs make; every RMS finite."""
    import numpy as np

    from nestinet_tpu_torch.scripts import run_quality, switching_demo

    cut = os.path.join(tmp, "quality_full_data")
    os.makedirs(cut)
    lists = {ts + ".txt" for ts in run_quality.TESTSETS}
    for name in os.listdir(data):
        if name not in lists:
            os.symlink(os.path.join(data, name), os.path.join(cut, name))
    for ts in lists:
        with open(os.path.join(data, ts)) as f:
            first = f.read().split()[0]
        with open(os.path.join(cut, ts), "w") as f:
            f.write(first + "\n")
    for k in kernels:
        k.reset_launches()
    got, _ = _quiet(run_quality.main, [run, "--data", cut, "--batch", str(DEVICE_BATCH),
                                       "--results_name", "full", "--device", "cuda",
                                       "--extraction", "device", "--mode", "sparse",
                                       "--dtype", "int8", "--fold_bn", "1"])
    q_launches = _launch_counts(kernels)
    stats = got["stats"].values()
    batches, patches = sum(st["n_batches"] for st in stats), sum(st["n_patches"] for st in stats)
    runs = sum(st["expert_runs"] for st in stats)
    rms = {ts: v["rms"] for ts, v in got["summary"].items()}
    print(f"phase 18d: run_quality at full width (phase 7's run dir, random weights, "
          f"device-sparse int8+fold, one shape a testset): {patches} patches in {batches} "
          f"batches, {runs} expert runs, {patches / sum(st['seconds'] for st in stats):.1f} "
          f"patches/s, RMS " + ", ".join(f"{ts} {v:.3f}" for ts, v in rms.items())
          + f" deg, launches {q_launches} [{card}]", flush=True)
    if len(rms) != 6 or not all(np.isfinite(v) for v in rms.values()):
        fail(f"phase 18d: run_quality at full width gave {rms}")
    if q_launches["tdmfv_n_est"] != batches or int8_launches(q_launches) == 0:
        fail(f"phase 18d: run_quality at full width launched {q_launches} for {batches} "
             f"batches")
    check_int8_launches("phase 18d run_quality", q_launches, batches, runs, int8_per)

    sw_data = os.path.join(tmp, "switching")
    with open(os.path.join(sw_data, "testset_switching.txt")) as f:
        names = f.read().split()
    with open(os.path.join(sw_data, "testset_switching_noise_levels.txt")) as f:
        levels = dict(zip(names, f.read().split()))
    with open(os.path.join(sw_data, "testset_two.txt")) as f:
        two = f.read().split()
    with open(os.path.join(sw_data, "testset_demo.txt"), "w") as f:
        f.write("\n".join(two) + "\n")
    with open(os.path.join(sw_data, "testset_demo_noise_levels.txt"), "w") as f:
        f.write("\n".join(levels[n] for n in two) + "\n")
    for k in kernels:
        k.reset_launches()
    sw, _ = _quiet(switching_demo.main, [os.path.join(tmp, "run_ms_sw_n_est"), "--data",
                                         sw_data, "--testset", "testset_demo.txt",
                                         "--batch", str(DEVICE_BATCH), "--device", "cuda"])
    sw_launches = _launch_counts(kernels)
    sw_batches = -(-sw["n_patches"] // DEVICE_BATCH)
    print(f"phase 18d: switching_demo at full width (phase 14a's run dir, random weights, "
          f"{len(two)} shapes): {sw['n_patches']} patches, small-branch share "
          f"{sw['small_branch_share']:.4f}, RMS {sw['rms_deg']:.3f} deg, per noise level "
          f"{sw['per_sigma']}, launches {sw_launches}, {sw['seconds']:.2f} s of serving "
          f"[{card}]", flush=True)
    finite = [sw["rms_deg"], *(v for row in sw["per_sigma"].values() for v in row.values())]
    if not sw["n_patches"] or not all(np.isfinite(v) for v in finite):
        fail(f"phase 18d: switching_demo at full width gave {sw}")
    if sw_launches["tdmfv_n_est"] != sw_batches:
        fail(f"phase 18d: switching_demo at full width launched {sw_launches} for "
             f"{sw_batches} batches")
    return {"run_quality": {"rms": rms, "patches": patches, "batches": batches,
                            "expert_runs": runs, "launches": q_launches},
            "switching_demo": {"rms_deg": sw["rms_deg"], "n_patches": sw["n_patches"],
                               "small_branch_share": sw["small_branch_share"],
                               "launches": sw_launches}}


def phase18(tmp, data, run, dev, kernels, card, int8_per) -> dict:
    """Phase 18: the quality bar on the committed trained run dirs (a, b),
    the learned GMM on the card (c), and the two quality scripts at full
    width (d)."""
    t18 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    record = {"quality": phase18a(tmp, root, kernels, card),
              "switching": phase18b(tmp, root, kernels, card),
              "learned_gmm": phase18c(dev, card),
              "full_width": phase18d(tmp, data, run, kernels, card, int8_per)}
    record["seconds"] = time.perf_counter() - t18
    print(f"phase 18: the phase took {record['seconds']:.1f} s", flush=True)
    return record


# ---------------------------------------------------------------- phase 19

MODELNET_FIXTURE = os.path.join("nestinet_tpu_torch", "testdata", "modelnet_h5")
EXPORT_TESTSET = "testset"  # phase 19a: the list of phase 18a's results it exports
PHASE19_BUDGET_S = 60.0


def export_files(lists: dict) -> list:
    """The files `cli.evaluate --export_visualizations 1 --expert_statistics
    1` writes into a results dir holding `.experts` files, for {list name:
    its shapes}: JAX's set (tests/test_torch_cli_tools.py holds this rule
    against the files JAX's CLI writes)."""
    stats = "images/expert_statistics"
    files = {f"{stats}/avg_error_all.png", f"{stats}/point_count_all.png"}
    for name, shapes in lists.items():
        files |= {f"summary/{name}_evaluation_results.txt",
                  f"{stats}/{name}_expert_statistics.json"}
        for shape in shapes:
            files |= {f"images/phi_theta/{shape}_phi_theta_domain.png",
                      f"{stats}/avg_error/{shape}.png", f"{stats}/point_count/{shape}.png"}
            files |= {f"images/{shape}_{tag}.png"
                      for tag in ("normals_gt", "normals_pred", "error", "experts")}
    return sorted(files)


def _tree(root) -> set:
    return {os.path.relpath(os.path.join(d, n), root).replace(os.sep, "/")
            for d, _, names in os.walk(root) for n in names}


def phase19(tmp, card) -> dict:
    """Phase 19: what the card's machine draws and reads without
    matplotlib, PIL or h5py.  (a) `cli.evaluate --export_visualizations 1
    --expert_statistics 1` on phase 18a's device-sparse float32 results of
    one test list: exactly JAX's file set, every PNG decoding
    (`viz/png.py::read_png`) to its header's size with something drawn;
    (b) the committed ModelNet HDF5 fixture read through
    `data/modelnet.py` equal to its `expected.npz`, dtypes included."""
    import importlib.util

    import numpy as np

    from nestinet_tpu_torch.data import modelnet
    from nestinet_tpu_torch.viz.png import read_header, read_png

    t19 = time.perf_counter()
    data = os.path.join(tmp, "quality_data")
    served = os.path.join(tmp, "quality_run", "q1_results")  # 18a's device-sparse f32
    with open(os.path.join(data, EXPORT_TESTSET + ".txt")) as f:
        shapes = [x.strip() for x in f if x.strip()]
    results = os.path.join(tmp, "phase19_results")
    os.makedirs(results)
    for shape in shapes:
        for ext in (".normals", ".experts"):
            shutil.copy(os.path.join(served, shape + ext), results)
    inputs = _tree(results)
    cli_s = run_module("nestinet_tpu_torch.cli.evaluate", "--normal_results_path", results,
                       "--data_path", data, "--dataset_list", EXPORT_TESTSET,
                       "--export_visualizations", "1", "--expert_statistics", "1",
                       "--n_experts", str(N_EXPERTS))
    written = sorted(_tree(results) - inputs)
    want = export_files({EXPORT_TESTSET: shapes})
    if written != want:
        fail(f"phase 19a: cli.evaluate wrote {sorted(set(written) ^ set(want))} beyond or "
             f"short of JAX's {len(want)} files")
    nbytes = sum(os.path.getsize(os.path.join(results, f)) for f in written)
    pngs = [f for f in written if f.endswith(".png")]
    for f in pngs:
        path = os.path.join(results, f)
        img = read_png(path)
        w, h = read_header(path)[:2]
        if img.shape != (h, w, 4) or not (img[..., :3] != 255).any():
            fail(f"phase 19a: {f} decodes to {img.shape} (header {w} x {h}) or is blank")
    t19b = time.perf_counter()
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), MODELNET_FIXTURE)
    train, seg = modelnet.get_data_files(os.path.join(fixture, "files.txt"))
    got = {"train": modelnet.load_h5_with_normals(train), "seg": modelnet.load_h5_with_seg(seg)}
    with np.load(os.path.join(fixture, "expected.npz")) as z:
        want_h5 = {"train": (z["train_data"], z["train_label"], z["train_normal"]),
                   "seg": (z["seg_data"], z["seg_label"], z["seg_pid"])}
        for key, arrays in want_h5.items():
            for a, b in zip(got[key], arrays, strict=True):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f"phase 19b: {key} read as {a.dtype} {a.shape}, not {b.dtype} {b.shape}"
                         " equal to expected.npz")
    h5_s = time.perf_counter() - t19b
    libs = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "PIL", "h5py")}
    secs = time.perf_counter() - t19
    print(f"phase 19: importable {libs}; 19a cli.evaluate --export_visualizations 1 "
          f"--expert_statistics 1 on {EXPORT_TESTSET} ({len(shapes)} shapes of 18a's "
          f"device-sparse f32 results): {len(written)} files ({len(pngs)} PNG), {nbytes} bytes, "
          f"JAX's file set, every PNG decoded, {cli_s:.1f} s; 19b the ModelNet HDF5 fixture "
          f"equal to expected.npz, {h5_s:.2f} s; the phase took {secs:.1f} s [{card}]",
          flush=True)
    if secs > PHASE19_BUDGET_S:
        fail(f"phase 19 took {secs:.1f} s, over its {PHASE19_BUDGET_S} s")
    return {"importable": libs, "files": len(written), "pngs": len(pngs), "bytes": nbytes,
            "cli_seconds": cli_s, "h5_seconds": h5_s, "seconds": secs}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="GPU smoke test of the PyTorch port")
    parser.add_argument("--record", default=None,
                        help="also write every measured number to this JSON file")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nestinet_tpu_torch.core.device import cuda_median_ms, resolve_device, set_f32_numerics

    dev = resolve_device("cuda")
    set_f32_numerics()
    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    record = {"gpu": card, "device_name": name, "torch": torch.__version__}

    # ---- 2. build: one nvcc per library, started together ----
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.kernels import int8_cuda, mups_cuda, pool_cuda
    from nestinet_tpu_torch.ops.kernels.build import build_all
    from nestinet_tpu_torch.scripts import mups_kernel_exp

    kernel = mups_cuda.KERNEL
    kernels = (kernel, *int8_cuda.KERNELS, *pool_cuda.KERNELS)
    t0 = time.perf_counter()
    paths = build_all(kernels)
    secs = time.perf_counter() - t0
    for lib_kernel, path in zip(kernels, paths):
        lib = lib_kernel.lib()
        print(f"build: {lib_kernel.name} -> {os.path.relpath(path)}", flush=True)
        for line in lib_kernel.ptxas_log.splitlines():
            if any(t in line for t in ("entry function", "registers", "spill")):
                print(f"  ptxas: {line.strip()}")
        for k in lib_kernel.launches:
            if not hasattr(lib, k + "_launch"):
                fail(f"the library has no {k}_launch")
            if lib_kernel.ptxas_log and f"{k}_kernel" not in lib_kernel.ptxas_log:
                fail(f"ptxas compiled no {k}_kernel")
    print(f"build: {len(kernels)} libraries in {secs:.2f} s", flush=True)
    record["build_seconds"] = secs

    # ---- 3. MuPS kernel against its plain version ----
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm

    gmm = get_3d_grid_gmm([8, 8, 8], variance=0.0156)
    gmm_t = tuple(torch.from_numpy(a).to(dev) for a in gmm.astuple())
    gen = torch.Generator().manual_seed(SEED)
    k1_err = max(check_kernel(gen, dev, gmm_t, 3 * HOST_BATCH),
                 check_kernel(gen, dev, gmm_t, 3 * DEVICE_BATCH))
    check_gradient(gen, dev)
    wide_err = check_wide(gen, dev)

    # ---- 4. blocked MuPS kernel, then its entry point ----
    k2_err, k2_diff = check_blocked(gen, dev, gmm_t)
    kernel.reset_launches()
    exp = mups_kernel_exp.main(["--blocks", ",".join(map(str, BLOCKS))])
    exp_launches = dict(kernel.launches)
    print(f"mups_kernel_exp: launches {exp_launches}", flush=True)
    if exp_launches["tdmfv_n_est_blocked"] <= 0:
        fail("the entry point did not launch the blocked kernel")
    for r in exp:
        if not r["max_abs_err"] <= KERNEL_ATOL:
            fail(f"mups_kernel_exp: block_b={r['block_b']} err {r['max_abs_err']}")
    served = check_served_rows(dev, gmm_t, card)
    k1_err = max(k1_err, wide_err, served["max_abs_err"])
    k2_err = max(k2_err, wide_err, served["blocked_max_abs_err"])

    # ---- 5. the int8 kernels against their plain version at every served shape ----
    i8_err, i8_rows, i8_widest = check_int8_kernel(gen, dev, card)

    # ---- 5b. the max pool kernel against aten's at every served pool shape ----
    pool_rows = check_max_pool(dev, card)

    # ---- 5c. the average pool kernel against its plain version at every served pool ----
    avg_rows, relu_neg_zero = check_avg_pool(dev, card)

    from nestinet_tpu_torch.core import checkpoint
    from nestinet_tpu_torch.core.config import Config
    from nestinet_tpu_torch.core.rundir import RunDir
    from nestinet_tpu_torch.data.loader import get_data_loader
    from nestinet_tpu_torch.data.synthetic import build_protocol_benchmark
    from nestinet_tpu_torch.infer.device_pipeline import extract_batch, predict_shapes_device
    from nestinet_tpu_torch.infer.predict import load_run, pad_batch, predict_shapes
    from nestinet_tpu_torch.models import build_model

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        build_protocol_benchmark(data, n_points=N_POINTS, n_pidx=500, seed=SEED % 1000)
        with open(os.path.join(data, "testset.txt")) as f:
            shapes = [s.strip() for s in f if s.strip()]
        for tlist, n in (("testset_one", 1), ("testset_two", 2)):
            with open(os.path.join(data, tlist + ".txt"), "w") as f:
                f.write("\n".join(shapes[:n]) + "\n")
        print(f"dataset: {len(shapes)} shapes x {N_POINTS} points, built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        cfg = Config(model="experts_n_est", log_dir=os.path.join(tmp, "run"),
                     data_path=data, patch_radius=(0.01, 0.03, 0.05), num_point=512,
                     num_gaussians=8, n_experts=N_EXPERTS, seed=SEED)

        # ---- 6. device extraction, card against CPU ----
        grids, queries, radii, bseed, caps = check_extraction(
            dev, data, shapes[0], cfg.patch_radius)
        ex_ms = cuda_median_ms(lambda: extract_batch(
            grids, queries, radii, bseed, num_point=cfg.num_point, caps=caps),
            warmup=2, iters=10)

        rd = RunDir.create(cfg.log_dir)
        cfg.save(rd.config_path)
        run_gmm = get_3d_grid_gmm([8, 8, 8], variance=cfg.gmm_variance)
        run_gmm.save(rd.gmm_path)
        wgen = torch.Generator().manual_seed(SEED)
        model = build_model(cfg, run_gmm, wgen)
        randomize_bn(model, wgen)
        spread_manager_logits(model.to(dev), grids, queries, radii, bseed, caps)
        checkpoint.save(rd.path, model.cpu().state_dict())
        n_params = sum(v.numel() for v in model.state_dict().values())
        int8_per = int8_calls(model)
        del model
        print(f"run dir: experts_n_est, {n_params} weights", flush=True)

        # ---- 7. the routed slice: device extraction + argmax-only routing ----
        dev_sparse = serve("device-sparse", lambda: predict_shapes_device(
            rd.path, testset="testset.txt", data_path=data, batch_size=DEVICE_BATCH,
            moe_inference="sparse"), kernels, card)
        summary = check_outputs(data, dev_sparse["output_dir"], "testset", N_EXPERTS)
        print(f"evaluate device-sparse: testset RMS {summary['rms']:.4f} deg (random "
              f"weights), PGP10 {summary['pgp10']:.4f}", flush=True)
        dev_sparse["rms"] = summary["rms"]

        # ---- 8. host extraction, routed, on two shapes ----
        host_sparse = serve("host-sparse", lambda: predict_shapes(
            rd.path, dataset_name="pcpnet_sparse", testset="testset_two.txt", data_path=data,
            batch_size=HOST_BATCH, loader_workers=8, moe_inference="sparse"), kernels, card)
        host_sparse["rms"] = check_outputs(
            data, host_sparse["output_dir"], "testset_two", N_EXPERTS)["rms"]

        # ---- 9. host extraction, dense, on one shape ----
        host_dense = serve("host-dense", lambda: predict_shapes(
            rd.path, dataset_name="pcpnet_dense", testset="testset_one.txt", data_path=data,
            batch_size=HOST_BATCH, loader_workers=8, moe_inference="dense"), kernels, card)
        host_dense["rms"] = check_outputs(
            data, host_dense["output_dir"], "testset_one", N_EXPERTS)["rms"]
        print(f"evaluate: RMS host-sparse (two shapes) {host_sparse['rms']:.4f} deg, host-dense "
              f"(one shape) {host_dense['rms']:.4f} deg (random weights)", flush=True)

        # one device batch routed and dense; one host batch on the plain MuPS
        _, _, _, model = load_run(rd.path, dev)
        with torch.inference_mode():
            points, n_eff = extract_batch(grids, queries, radii, bseed,
                                          num_point=cfg.num_point, caps=caps)
            grid = model.mups_grid(points, n_eff)
        real = DEVICE_BATCH - 16  # the last 16 rows stand for padding
        (nrm_s, ids_s, probs_s), (nrm_d, ids_d, probs_d) = one_batch(model, grid, real)
        counts = torch.bincount(ids_s, minlength=N_EXPERTS).tolist()
        route_err = (nrm_s - nrm_d).abs().max().item()
        ids_equal = bool((ids_s == ids_d).all())
        print(f"routed vs dense, one device batch: ids equal {ids_equal}, patches per "
              f"expert {counts}, normals max abs err {route_err:.3e} (atol {NORMALS_ATOL})",
              flush=True)
        if not ids_equal:
            fail("argmax expert ids differ between routed and dense serving")
        perr = (probs_s - probs_d).abs().max().item()
        if not perr <= 1e-6:
            fail(f"manager probabilities differ between routed and dense serving: {perr}")
        if not route_err <= NORMALS_ATOL:
            fail(f"normals differ between routed and dense serving: {route_err}")

        loader, _ = get_data_loader(
            "testset.txt", indir=data, batch_size=HOST_BATCH, patch_radius=cfg.patch_radius,
            points_per_patch=cfg.num_point, seed=cfg.seed, workers=8,
        )
        batch = pad_batch(next(iter(loader)), HOST_BATCH)
        h_points = torch.from_numpy(batch["points"]).to(dev)
        h_n_eff = torch.from_numpy(batch["n_eff"].astype(np.int32)).to(dev)
        with torch.inference_mode():
            out_k = model(h_points, h_n_eff)
            plain_rows = mups_ops.tdmfv_n_est_reference(
                h_points.reshape(-1, cfg.num_point, 3), model.gmm_w, model.gmm_mu,
                model.gmm_sigma, h_n_eff.reshape(-1),
            )
            out_p = model.forward_grid(
                mups_ops.stats_to_grid(plain_rows, HOST_BATCH, cfg.n_scales, model.resolution))
            torch.cuda.synchronize()
            ids_k, _ = model.predict_experts(out_k)
            ids_p, _ = model.predict_experts(out_p)
            nrm_k, nrm_p = model.predict_normals(out_k), model.predict_normals(out_p)
        nerr = (nrm_k - nrm_p).abs().max().item()
        print(f"batch vs plain MuPS: ids equal {bool((ids_k == ids_p).all())}, normals max "
              f"abs err {nerr:.3e} (atol {NORMALS_ATOL}), max |normal| "
              f"{nrm_k.abs().max().item():.3f}", flush=True)
        if not bool((ids_k == ids_p).all()):
            fail("argmax expert ids differ between the kernel and the plain MuPS")
        if not nerr <= NORMALS_ATOL:
            fail(f"normals differ between the kernel and the plain MuPS: {nerr}")

        # ---- 10. serving dtypes, device-sparse at full width ----
        dtype_runs = {}
        for label, dtype, fold in DTYPE_PATHS:
            dtype_runs[label] = serve(f"device-sparse {label}", lambda: predict_shapes_device(
                rd.path, dataset_name=f"pcpnet_device_{dtype}_fold{int(fold)}",
                testset="testset.txt", data_path=data, batch_size=DEVICE_BATCH,
                moe_inference="sparse", compute_dtype=dtype, fold_bn=fold),
                kernels, card, int8=dtype == "int8", int8_per=int8_per)
            dtype_runs[label]["rms"] = check_outputs(
                data, dtype_runs[label]["output_dir"], "testset", N_EXPERTS)["rms"]
        print("evaluate: RMS " + ", ".join(f"{k} {v['rms']:.4f} deg" for k, v in
                                          dtype_runs.items()) + " (random weights)", flush=True)

        # ---- 11. one device batch in each dtype, routed and dense ----
        with torch.inference_mode():
            mgr_split = {"f32": device_time_split(lambda: model.manager_probs(grid))}
            mgr_ms = {"f32": cuda_median_ms(lambda: model.manager_probs(grid), warmup=2,
                                            iters=10)}
        pools = {"f32": (pool_launches(lambda: model.manager_probs(grid)),
                         pool_launches(lambda: model.expert_on_grid(0, grid)))}
        avg_pools = {"f32": (pool_launches(lambda: model.manager_probs(grid), "avg_pool3d"),
                             pool_launches(lambda: model.expert_on_grid(0, grid), "avg_pool3d"))}
        gaps, launch_counts, expert_split = {}, {}, {}
        for label, dtype, fold in DTYPE_PATHS:
            _, _, _, m = load_run(rd.path, dev, dtype, fold)
            with torch.inference_mode():
                g = m.mups_grid(points, n_eff)
            (n_r, i_r, _), (n_d, i_d, _) = one_batch(m, g, real)
            if not bool((i_r == i_d).all()):
                fail(f"{label}: manager ids differ between routed and dense serving")
            diff = (n_r - n_d).abs().max().item()
            scale = n_d.abs().max().item()
            same = i_r == ids_s
            gaps[label] = {"ids_agree_with_f32": same.float().mean().item(),
                           "max_angle_deg_vs_f32": angles_deg(n_r[same], nrm_s[same]).max().item(),
                           "routed_vs_dense_normals_max_abs_diff": diff}
            print(f"{label}, one device batch: routed vs dense ids equal, normals max abs diff "
                  f"{diff:.3e} (max |normal| {scale:.3f}); against float32: ids agree on "
                  f"{gaps[label]['ids_agree_with_f32']:.3f}, max angle "
                  f"{gaps[label]['max_angle_deg_vs_f32']:.2f} deg (random weights)", flush=True)
            if dtype == "bfloat16" and not diff <= BF16_ROUTED_RTOL * scale:
                fail(f"{label}: normals differ between routed and dense serving: {diff}")
            pools[label] = (pool_launches(lambda: m.manager_probs(g)),
                            pool_launches(lambda: m.expert_on_grid(0, g)))
            avg_pools[label] = (pool_launches(lambda: m.manager_probs(g), "avg_pool3d"),
                                pool_launches(lambda: m.expert_on_grid(0, g), "avg_pool3d"))
            with torch.inference_mode():
                mgr_split[label] = device_time_split(lambda: m.manager_probs(g))
                mgr_ms[label] = cuda_median_ms(lambda: m.manager_probs(g), warmup=2, iters=10)
                if dtype == "int8":
                    launch_counts[label] = int8_launch_counts(m, g, real)
                    expert_split[label] = device_time_split(lambda: m.expert_on_grid(0, g))
            del m
        from nestinet_tpu_torch.models import backbones

        want_pools = (len(backbones.pool_inputs(backbones.CONV_NET_8G, 60, 8)),
                      len(backbones.pool_inputs(backbones.expert_backbone_8g(128 // 3), 20, 8)))
        print(f"launches: the max pool kernel in one manager call and one expert run "
              f"{pools} (one a pool: {want_pools})", flush=True)
        if any(p != want_pools for p in pools.values()):
            fail(f"the max pool kernel's launches {pools}, where the pools make {want_pools}")
        want_avg = (len(backbones.avg_pool_inputs(backbones.CONV_NET_8G, 60, 8)),
                    len(backbones.avg_pool_inputs(backbones.expert_backbone_8g(128 // 3), 20, 8)))
        print(f"launches: the average pool kernel in one manager call and one expert run "
              f"{avg_pools} (one an Inception block: {want_avg})", flush=True)
        if any(p != want_avg for p in avg_pools.values()):
            fail(f"the average pool kernel's launches {avg_pools}, where the Inception blocks "
                 f"make {want_avg}")
        for label, (dev_ms, conv, int8, gemm) in mgr_split.items():
            print(f"time: manager {label} {mgr_ms[label]:.3f} ms per batch of {DEVICE_BATCH}; "
                  f"profiled {dev_ms:.3f} ms of device time, convolutions {100 * conv:.1f}%, "
                  f"int8 kernels {100 * int8:.1f}% (the GEMM {100 * gemm:.1f}%) [{card}]",
                  flush=True)
        for label, (dev_ms, _, int8, gemm) in expert_split.items():
            print(f"time: an expert run of {DEVICE_BATCH} rows, {label}: {dev_ms:.3f} ms of "
                  f"device time, int8 kernels {100 * int8:.1f}% (the GEMM {100 * gemm:.1f}%) "
                  f"[{card}]", flush=True)
        for label, c in launch_counts.items():
            for part, want in (("manager", 0), ("expert_run", 1)):
                got = c[f"kernels_{part}"]
                if (int8_launches(got), got["int8_gemm"]) != (int8_per["all"][want],
                                                              int8_per["int8_gemm"][want]):
                    fail(f"{label}: one {part} call launched {got}, where its layers make "
                         f"{int8_per['all'][want]} int8 launches, "
                         f"{int8_per['int8_gemm'][want]} of them the GEMM's")
            runs = dtype_runs[label]["expert_runs"] / dtype_runs[label]["n_batches"]
            c["served_batch"] = c["manager"] + runs * c["expert_run"]
            print(f"launches {label}: {c['routed_batch']} device launches for a batch of "
                  f"{DEVICE_BATCH} routed on its own ({c['int8_kernel']} of the int8 kernels); "
                  f"the manager {c['manager']}, an expert run of {DEVICE_BATCH} rows "
                  f"{c['expert_run']}, so a batch served through the router ({runs:.3f} runs "
                  f"a batch in phase 10) {c['served_batch']:.1f}; {c['per_conv']} per conv "
                  f"with a forwarded bound, {c['per_first_conv']} for the grid's first conv; "
                  f"the int8 kernels' counts: the manager {c['kernels_manager']}, an expert "
                  f"run {c['kernels_expert_run']}", flush=True)

        # ---- 12. times ----
        k1_ms, plain_ms = {}, {}
        for R in (3 * HOST_BATCH, 3 * DEVICE_BATCH):
            pts, n_eff_rows = flagship_rows(gen, R, 512, "random", dev)
            k1_ms[R] = cuda_median_ms(
                lambda: mups_cuda.tdmfv_n_est_cuda(pts, *gmm_t, n_eff_rows))
            plain_ms[R] = cuda_median_ms(
                lambda: mups_ops.tdmfv_n_est_reference(pts, *gmm_t, n_eff_rows),
                warmup=2, iters=10)
            print(f"time: MuPS kernel {k1_ms[R]:.4f} ms, plain {plain_ms[R]:.4f} ms per {R} "
                  f"rows (N=512, K=512) [{card}]", flush=True)
        blocked = {bb: cuda_median_ms(lambda bb=bb: mups_cuda.tdmfv_n_est_blocked_cuda(
            pts, *gmm_t, n_eff_rows, bb)) for bb in BLOCKS}
        # both kernels do the same work on these rows: one bound
        k1_bound = k2_bound = mups_bound(n_eff_rows, 512, gmm_t[0].numel())
        print(f"time: blocked MuPS kernel per {R} rows: " + ", ".join(
            f"block_b={bb} {ms:.4f} ms ({ms / k1_ms[R]:.2f}x kernel 1)"
            for bb, ms in blocked.items()) + f" [{card}]", flush=True)
        print(f"time: MuPS kernel 1 {k1_ms[R]:.4f} ms per {R} random rows, bound "
              f"{k1_bound[0]:.4f} ms ({k1_bound[1]}, {100 * k1_bound[0] / k1_ms[R]:.1f}%); "
              f"{served['ms']:.4f} ms per {R} served rows, bound {served['bound'][0]:.4f} ms "
              f"({100 * served['bound'][0] / served['ms']:.1f}%) [{card}]", flush=True)
        with torch.inference_mode():
            fwd_ms = cuda_median_ms(lambda: model(h_points, h_n_eff), warmup=2, iters=10)
        print(f"time: extraction {ex_ms:.3f} ms per batch of {DEVICE_BATCH} (3 radii, lanes "
              f"{list(caps)}); dense forward {fwd_ms:.3f} ms per batch of {HOST_BATCH} "
              f"[{card}]", flush=True)
        for label, st in (("device-sparse", dev_sparse), ("host-sparse", host_sparse),
                          ("host-dense", host_dense),
                          *((f"device-sparse {k}", v) for k, v in dtype_runs.items())):
            print(f"time: {label} {st['patches_per_sec']:.1f} patches/s, peak "
                  f"{st['peak_memory_gb']:.2f} GB [{card}]", flush=True)

        # ---- 13. training: the step against the CPU, timed, the trainer ----
        del model
        torch.cuda.empty_cache()
        t13 = time.perf_counter()
        train_cfg = Config(model="experts_n_est", patch_radius=cfg.patch_radius, num_point=512,
                           num_gaussians=8, n_experts=N_EXPERTS, seed=SEED)
        vs_cpu = check_train_step_against_cpu(dev, train_cfg, run_gmm, kernel)
        train_times = {d: time_train_steps(dev, train_cfg, run_gmm, d, kernel, card)
                       for d in ("float32", "bfloat16")}
        train_run = os.path.join(tmp, "train_run")
        train_s = train_cli(data, train_run, "--max_epoch", "2", "--profile_epoch", "1")
        with open(os.path.join(data, "trainingset_whitenoise.txt")) as f:
            train_shapes = f.read().split()
        with open(os.path.join(data, "trainingset_resume.txt"), "w") as f:
            f.write("\n".join(train_shapes[:RESUME_TRAIN_SHAPES]) + "\n")
        resume_s = train_cli(data, train_run, "--max_epoch", "3", "--resume", "1",
                             "--trainset", "trainingset_resume.txt")
        trained = check_trained_run(data, train_run)
        trained.update(check_tb_and_trace(train_run))
        print(f"phase 13: cli.train {train_s:.1f} s (2 epochs), resumed {resume_s:.1f} s (1 "
              f"epoch); the phase took {time.perf_counter() - t13:.1f} s", flush=True)

        # ---- 14. the ablation models: serving, training, a JAX run dir ----
        ablations, jax_fixture = phase14(tmp, data, dev, grids, queries, radii, bseed, caps,
                                         run_gmm, kernels, card)

        # ---- 15. the scan, the CLIs, the MuPS variants ----
        scan = phase15a(tmp, rd.path, kernels, card)
        tools = phase15b(tmp, data, rd.path, shapes, dev, kernels)

        # ---- 16. data parallelism: an NCCL world of one, two gloo ranks on the card ----
        dp, ep_step = phase16(tmp, data, dev, train_cfg, run_gmm, rd.path, dev_sparse, kernels,
                              card, int8_per)

        # ---- 17. expert parallelism: the 1 x 2 step (17a, run above), the CLI ----
        t17 = time.perf_counter()
        ep = {"step": ep_step} | phase17b(tmp, data, train_run, kernels, card)
        print(f"phase 17: 17b took {time.perf_counter() - t17:.1f} s; 17a's steps took "
              f"{[round(r['seconds'], 1) for r in ep_step['ranks']]} s a rank inside phase 16b's "
              f"launch", flush=True)

        # ---- 18. the quality bar, the quality scripts, the learned GMM ----
        quality = phase18(tmp, data, rd.path, dev, kernels, card, int8_per)

        # ---- 19. drawing and HDF5 without matplotlib, PIL or h5py ----
        drawn = phase19(tmp, card)
        if "jax" in sys.modules:
            fail("jax was imported")

    record.update({
        "train_step_vs_cpu": vs_cpu, "train_step": train_times, "trained_run": trained,
        "cli_train_seconds": [train_s, resume_s],
        "kernel_max_abs_err": k1_err, "blocked_max_abs_err": k2_err,
        "kernel_max_abs_err_k1000": wide_err,
        "blocked_max_diff_from_kernel": k2_diff, "kernel_ms": k1_ms, "plain_ms": plain_ms,
        "blocked_ms": blocked, "mups_kernel_exp": exp, "mups_served_rows": served,
        "extract_ms_b256": ex_ms,
        "forward_ms_b128": fwd_ms, "manager_ms_b256": mgr_ms, "manager_split_b256": mgr_split,
        "expert_run_split_b256": expert_split,
        "device_sparse": dev_sparse, "host_sparse": host_sparse, "host_dense": host_dense,
        "device_sparse_dtypes": dtype_runs, "dtype_gaps_one_batch": gaps,
        "int8_max_abs_err": i8_err, "int8_widest": i8_widest, "int8_by_shape": i8_rows,
        "int8_launch_counts": launch_counts, "mups_bound_ms": {"kernel": k1_bound,
                                                              "blocked": k2_bound},
        "routed_vs_dense_normals_max_abs_err": route_err,
        "batch_normals_max_abs_err": nerr,
        "ablations": ablations, "jax_run_dir_on_card": jax_fixture,
        "scan": scan, "cli_tools": tools, "data_parallel": dp, "expert_parallel": ep,
        "quality": quality, "drawing_and_hdf5": drawn, "max_pool": pool_rows,
        "max_pool_launches_manager_expert": pools, "avg_pool": avg_rows,
        "avg_pool_launches_manager_expert": avg_pools, "relu_of_neg_zero": relu_neg_zero,
    })
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)), exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(record, f, indent=2, default=str)

    R = 3 * DEVICE_BATCH
    # the largest pool: the 8^3 grid's at B = 256
    pool_wide = max((t for t in pool_rows if t["B"] == INT8_BATCH), key=lambda t: t["bytes"])
    avg_wide = max((t for t in avg_rows if t["B"] == INT8_BATCH), key=lambda t: t["bytes"])
    print(json.dumps({"kernels": [
        {
            "name": "tdmfv_n_est",
            "route": "cuda",
            "source": "nestinet_tpu_torch/csrc/mups_kernel.cu",
            "replaces": "nestinet_tpu/ops/pallas/mups_kernel.py:43",
            "launches": dev_sparse["launches"]["tdmfv_n_est"],
            "launches_per_train_step": vs_cpu["mups_launches_train_step"],
            "launches_per_eval_step": vs_cpu["mups_launches_eval_step"],
            "launches_ablations": {f"{m} {label}": st["launches"]["tdmfv_n_est"]
                                   for m, a in ablations.items()
                                   for label, st in a["serving"].items()},
            "launches_scan": scan["launches"]["tdmfv_n_est"],
            "launches_test_all": tools["launches"],
            "launches_traced_epoch": trained["trace_mups_kernel_events"],
            "launches_data_parallel": dp_launches(dp, "tdmfv_n_est"),
            "launches_expert_parallel": {
                "train_step_per_rank": [r["launches"] for r in ep["step"]["ranks"]],
                "cli_test": ep["cli_test_launches"]["tdmfv_n_est"]},
            "launches_quality": {m: q["launches"]["tdmfv_n_est"]
                                 for m, q in quality["quality"].items()},
            "launches_switching_demo": quality["switching"]["launches"]["tdmfv_n_est"],
            "launches_full_width_scripts": {
                s: quality["full_width"][s]["launches"]["tdmfv_n_est"]
                for s in ("run_quality", "switching_demo")},
            "max_abs_err_learned_gmm": quality["learned_gmm"]["max_abs_err"],
            "ms_learned_gmm": quality["learned_gmm"]["ms"],
            "max_abs_err": k1_err,
            "ms": k1_ms[R],
            "plain_ms": plain_ms[R],
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
            "ms_served_rows": served["ms"],
            "bound_ms_served_rows": served["bound"][0],
            "max_abs_err_served_rows": served["max_abs_err"],
        },
        {
            "name": "tdmfv_n_est_blocked",
            "route": "cuda",
            "source": "nestinet_tpu_torch/csrc/mups_kernel.cu",
            "replaces": "scripts/mups_kernel_exp.py:32",
            "launches": exp_launches["tdmfv_n_est_blocked"],
            "launches_data_parallel": dp_launches(dp, "tdmfv_n_est_blocked"),
            "max_abs_err": k2_err,
            "ms": blocked[max(BLOCKS)],
            "plain_ms": plain_ms[R],
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "library_ms": None,
            "ms_by_block_b": blocked,
            "ms_served_rows": served["blocked_ms"][max(BLOCKS)],
            "ms_served_rows_by_block_b": served["blocked_ms"],
            "diff_from_kernel_learned_gmm": quality["learned_gmm"]["blocked_diff"],
        },
        {
            "name": "int8_conv3d",
            "route": "cuda",
            "source": "nestinet_tpu_torch/csrc/int8_conv.cu",
            "replaces": "nestinet_tpu/ops/quant.py:85",
            "launches": dtype_runs["int8"]["launches"]["int8_conv3d"],
            "launches_int8_fold": dtype_runs["int8+fold"]["launches"]["int8_conv3d"],
            "launches_per_manager_batch": launch_counts["int8"]["kernels_manager"]["int8_conv3d"],
            "launches_per_expert_run":
                launch_counts["int8"]["kernels_expert_run"]["int8_conv3d"],
            "launches_ss_int8_fold":
                ablations["ss_norm_est"]["serving"]["int8+fold"]["launches"]["int8_conv3d"],
            "launches_data_parallel": dp_launches(dp, "int8_conv3d"),
            "launches_quality": {m: q["launches"]["int8_conv3d"]
                                 for m, q in quality["quality"].items()},
            "launches_full_width_run_quality":
                quality["full_width"]["run_quality"]["launches"]["int8_conv3d"],
            "max_abs_err": i8_err,
            "ms": i8_widest["conv"]["ms"],
            "plain_ms": i8_widest["conv"]["plain_ms"],
            "bound_ms": i8_widest["conv"]["bound_ms"],
            "bound_by": i8_widest["conv"]["bound_by"],
            "library_ms": None,
            "tops": i8_widest["conv"]["tops"],
            "by_shape": [t for t in i8_rows if t["kernel"] != "gemm"],
        },
        {
            "name": "int8_gemm",
            "route": "cuda",
            "source": "nestinet_tpu_torch/csrc/int8_gemm.cu",
            "replaces": "nestinet_tpu/ops/quant.py:129",
            "launches": dtype_runs["int8"]["launches"]["int8_gemm"],
            "launches_int8_fold": dtype_runs["int8+fold"]["launches"]["int8_gemm"],
            "launches_per_manager_batch": launch_counts["int8"]["kernels_manager"]["int8_gemm"],
            "launches_per_expert_run": launch_counts["int8"]["kernels_expert_run"]["int8_gemm"],
            "launches_ss_int8_fold":
                ablations["ss_norm_est"]["serving"]["int8+fold"]["launches"]["int8_gemm"],
            "launches_data_parallel": dp_launches(dp, "int8_gemm"),
            "launches_quality": {m: q["launches"]["int8_gemm"]
                                 for m, q in quality["quality"].items()},
            "launches_full_width_run_quality":
                quality["full_width"]["run_quality"]["launches"]["int8_gemm"],
            "max_abs_err": i8_err,
            "ms": i8_widest["gemm"]["ms"],
            "plain_ms": i8_widest["gemm"]["plain_ms"],
            "bound_ms": i8_widest["gemm"]["bound_ms"],
            "bound_by": i8_widest["gemm"]["bound_by"],
            "library_ms": i8_widest["gemm"]["library_ms"],
            "tops": i8_widest["gemm"]["tops"],
            "by_shape": [t for t in i8_rows if t["kernel"] == "gemm"],
        },
        {
            "name": "max_pool3d",
            "route": "cuda",
            "source": "nestinet_tpu_torch/csrc/max_pool.cu",
            "replaces": "none: XLA's reduce_window in nestinet_tpu/ops/nn.py:347",
            "launches": dev_sparse["launches"]["max_pool3d"],
            "launches_int8_fold": dtype_runs["int8+fold"]["launches"]["max_pool3d"],
            "launches_per_manager_batch": pools["int8+fold"][0],
            "launches_per_expert_run": pools["int8+fold"][1],
            "max_abs_err": 0.0,
            "ms": pool_wide["ms"],
            "plain_ms": pool_wide["plain_ms"],
            "bound_ms": pool_wide["bound_ms"],
            "bound_by": "bytes",
            "library_ms": pool_wide["library_ms"],
            "by_shape": pool_rows,
        },
        {
            "name": "avg_pool3d",
            "route": "cuda",
            "source": "nestinet_tpu_torch/csrc/avg_pool.cu",
            "replaces": "none: XLA's reduce_window in nestinet_tpu/ops/nn.py:394-414",
            "launches": dev_sparse["launches"]["avg_pool3d"],
            "launches_int8_fold": dtype_runs["int8+fold"]["launches"]["avg_pool3d"],
            "launches_per_manager_batch": avg_pools["int8+fold"][0],
            "launches_per_expert_run": avg_pools["int8+fold"][1],
            "max_abs_err": 0.0,
            "ms": avg_wide["ms"],
            "plain_ms": avg_wide["plain_ms"],
            "bound_ms": avg_wide["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "by_shape": avg_rows,
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
