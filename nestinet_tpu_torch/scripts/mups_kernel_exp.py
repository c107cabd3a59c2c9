"""Experiment: the blocked MuPS kernel (`block_b` rows per ticket) against
its plain PyTorch version, on the card.

Counterpart of `scripts/mups_kernel_exp.py`: the same flags and the same
seeded inputs (`RandomState(0)`, points uniform in [-1, 1]^3, n_eff in
[N/2, N]); for each block_b it prints the kernel's time (CUDA events,
median of 10) and its max abs error against `tdmfv_n_est_reference`.

    python -m nestinet_tpu_torch.scripts.mups_kernel_exp --batch 768 --blocks 1,2,4,8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.device import cuda_median_ms, resolve_device, set_f32_numerics
from ..ops.gmm import get_3d_grid_gmm
from ..ops.kernels import mups_cuda
from ..ops.mups import tdmfv_n_est_reference


def forward_blocked(points, w, mu, sigma, n_eff, block_b: int) -> torch.Tensor:
    """[R, N, 3] points, [R] n_eff -> [R, 20, K], `block_b` rows per ticket.

    A CUDA tensor runs the blocked kernel; a CPU tensor the plain version.
    R must be a multiple of `block_b`, on either device.
    """
    R = points.shape[0]
    if block_b <= 0 or R % block_b != 0:
        raise ValueError(f"{R} rows do not divide into blocks of {block_b}")
    if points.device.type == "cpu":
        return tdmfv_n_est_reference(points, w, mu, sigma, n_eff)
    return mups_cuda.tdmfv_n_est_blocked_cuda(points, w, mu, sigma, n_eff, block_b)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=768)  # 256 patches x 3 scales
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--blocks", default="1,2,4,8")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    set_f32_numerics()
    B, N = args.batch, args.n
    gmm = get_3d_grid_gmm([8, 8, 8], variance=0.0156)
    w, mu, sigma = (torch.from_numpy(a).to(dev) for a in gmm.astuple())
    rng = np.random.RandomState(0)
    pts = torch.from_numpy(rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)).to(dev)
    n_eff = torch.from_numpy(rng.randint(N // 2, N + 1, B).astype(np.int32)).to(dev)

    ref = tdmfv_n_est_reference(pts, w, mu, sigma, n_eff)
    plain_ms = cuda_median_ms(lambda: tdmfv_n_est_reference(pts, w, mu, sigma, n_eff),
                              warmup=1, iters=10)
    print(f"plain: {plain_ms:8.3f} ms per {B} rows (N={N}, K={mu.shape[0]})", flush=True)
    results = []
    for bb in [int(x) for x in args.blocks.split(",")]:
        out = forward_blocked(pts, w, mu, sigma, n_eff, bb)
        err = (out - ref).abs().max().item()
        ms = cuda_median_ms(lambda bb=bb: forward_blocked(pts, w, mu, sigma, n_eff, bb),
                            warmup=2, iters=10)
        print(f"block_b={bb}: {ms:8.3f} ms  max_err={err:.2e}", flush=True)
        results.append({"block_b": bb, "ms": ms, "max_abs_err": err, "plain_ms": plain_ms})
    return results


if __name__ == "__main__":
    main()
