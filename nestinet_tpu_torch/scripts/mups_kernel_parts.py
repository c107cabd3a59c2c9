"""Where MuPS kernel 1's time goes: the kernel timed with one stage of its
work switched off at a time.

    python -m nestinet_tpu_torch.scripts.mups_kernel_parts [--rows 768] [--baseline SRC]

On the card only.  `csrc/mups_kernel.cu` holds a compile-time switch (the
PART_* macros) around each stage of `tdmfv_n_est_kernel` (the exponential,
the shared-divisor divisions, the float64 sums, the denominators'
reduction), the order of the tickets (longest rows first, or in row
order) and the tile size.  This script builds every variant with the
library's own nvcc flags, all at once, and times each with the flagship
8^3 Gaussians on two row sets: `--rows` rows of 512 random points in
[-1, 1]^3 with n_eff uniform in [0, 512), and the 768 rows of one served
batch at PCPNet's density (`served_rows`: 256 patches x 3 radii on a
100,000-point shape).  CUDA events, the median of 20 calls, the variants in
one order and then the reverse; the lower of the two is printed.  A
variant with a stage switched off computes garbage: the times say what
the rest costs, nothing else; the full kernel and the order and tile
variants are also held to the plain version (max abs error printed).

`--baseline SRC` also builds and times another `mups_kernel.cu` of the
interface before the ticket counter (its launch takes no counter), such as
an earlier checkout's, in the same turns.  The library the port serves with
is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..core.device import cuda_median_ms, resolve_device, set_f32_numerics
from ..data.synthetic import SHAPE_GENERATORS
from ..infer.device_pipeline import _dataset_window_caps, extract_batch
from ..ops.ball_query import build_grid
from ..ops.gmm import get_3d_grid_gmm
from ..ops.kernels import build, mups_cuda
from ..ops.mups import tdmfv_n_est_reference

VARIANTS = {
    "full": [],
    "no exp": ["-DPART_NO_EXP"],
    "no divisions": ["-DPART_NO_DIV"],
    "no sums": ["-DPART_NO_SUMS"],
    "no denominators": ["-DPART_NO_DEN"],
    "rows in order": ["-DPART_NO_SORT"],
    "tile 4": ["-DPART_TILE=4"],
    "tile 16": ["-DPART_TILE=16"],
}
# the variants that compute the statistics
EXACT = ("full", "rows in order", "tile 4", "tile 16")
PCPNET_POINTS = 100_000  # points of a PCPNet shape
FLAGSHIP_RADII = (0.01, 0.03, 0.05)  # fractions of the bounding-box diagonal


def served_rows(dev, seed: int, *, n_points: int = PCPNET_POINTS, radii_frac=FLAGSHIP_RADII,
                batch: int = 256, num_point: int = 512):
    """The MuPS rows of one served batch at PCPNet's density: a synthetic
    sphere of `n_points` points (`data/synthetic.py`) hashed into one grid
    per radius on `dev`, and `batch` of its points extracted as queries the
    way `predict_shapes_device` extracts them.  On a sphere of 100,000
    points n_eff is about 31, 270 and 512 at the three flagship radii.
    Returns (points [batch * radii, num_point, 3], n_eff [batch * radii]
    int32), a patch's radii in consecutive rows as the model reads them."""
    rng = np.random.RandomState(seed)
    cloud = SHAPE_GENERATORS["sphere"](n_points, rng)[0].astype(np.float32)
    shuffled = torch.from_numpy(cloud[rng.permutation(n_points)]).to(dev)
    bbdiag = float(np.linalg.norm(cloud.max(0) - cloud.min(0)))
    radii = [r * bbdiag for r in radii_frac]
    grids = [build_grid(shuffled, r) for r in radii]
    queries = torch.from_numpy(cloud[:batch]).to(dev)
    points, n_eff = extract_batch(grids, queries, radii, int(rng.randint(0, 2**31)),
                                  num_point=num_point,
                                  caps=_dataset_window_caps([cloud], radii_frac))
    return (points.reshape(-1, num_point, 3).contiguous(),
            n_eff.reshape(-1).to(torch.int32).contiguous())


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_variants(out_dir: str, baseline: str | None) -> dict:
    """One library per variant, one nvcc each, all started together."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build._nvcc()
    jobs = [(name, mups_cuda.KERNEL.source, flags) for name, flags in VARIANTS.items()]
    if baseline:
        jobs.append(("baseline", baseline, []))

    def make(i_job):
        i, (name, src, flags) = i_job
        path = os.path.join(out_dir, f"variant{i}.so")
        proc = subprocess.run([nvcc, *build.NVCC_FLAGS, *flags, "-o", path, src],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
        return _load(path), proc.stdout + proc.stderr

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(make, enumerate(jobs)))
    for (name, _, _), (_, log) in zip(jobs, built):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas [{name}]: {line.strip()}", flush=True)
    return {name: lib for (name, _, _), (lib, _) in zip(jobs, built)}


def _baseline_call(lib, pts, w, mu, sigma, n_eff):
    """The earlier interface: points, n_eff, w, mu, sigma, out, R, N, K, stream."""
    fn = lib.tdmfv_n_est_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    R, N, _ = pts.shape
    K = mu.shape[0]
    out = torch.empty((R, 20, K), dtype=torch.float32, device=pts.device)
    code = fn(pts.data_ptr(), n_eff.data_ptr(), w.data_ptr(), mu.data_ptr(),
              sigma.data_ptr(), out.data_ptr(), R, N, K,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"baseline launch failed: {lib.cuda_error_string(code).decode()}")
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=768)  # 256 patches x 3 scales
    ap.add_argument("--baseline", default=None,
                    help="another mups_kernel.cu (the interface without tickets) to time")
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR, "mups_parts"),
                    help="directory for the variant libraries")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    set_f32_numerics()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = build_variants(args.out, args.baseline)
    gen = torch.Generator().manual_seed(7)
    R, N = args.rows, 512
    pts = torch.rand((R, N, 3), generator=gen) * 2 - 1
    n_eff = torch.randint(0, N, (R,), generator=gen, dtype=torch.int32)
    pts[torch.arange(N)[None, :] > n_eff[:, None].long()] = 0.0
    w, mu, sigma = (torch.from_numpy(a).to(dev)
                    for a in get_3d_grid_gmm([8, 8, 8], variance=0.0156).astuple())
    sets = {"random": (pts.to(dev), n_eff.to(dev)), "served": served_rows(dev, seed=7)}
    served = mups_cuda.KERNEL._lib

    def call(name, rows):
        if name == "baseline":
            return _baseline_call(libs[name], rows[0], w, mu, sigma, rows[1])
        mups_cuda.KERNEL._lib = libs[name]
        return mups_cuda.tdmfv_n_est_cuda(rows[0], w, mu, sigma, rows[1])

    results = []
    try:
        for set_name, rows in sets.items():
            want = tdmfv_n_est_reference(rows[0], w, mu, sigma, rows[1])
            ms = {name: [] for name in libs}
            err = {}
            for name in libs:
                got = call(name, rows)
                torch.cuda.synchronize()
                err[name] = (got - want).abs().max().item()
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    ms[name].append(cuda_median_ms(lambda name=name: call(name, rows),
                                                   warmup=3, iters=20))
            ne = rows[1].clamp(max=N - 1) + 1
            print(f"MuPS kernel 1 by variant, {set_name} rows: {rows[1].numel()} rows (N={N}, "
                  f"K={mu.shape[0]}, real points a row min {int(ne.min())} mean "
                  f"{float(ne.float().mean()):.1f} max {int(ne.max())}) [{card}]", flush=True)
            for name, t in ms.items():
                held = (f"  max abs err {err[name]:.2e}" if name in EXACT or name == "baseline"
                        else "")
                print(f"  {name:16s} {min(t):.4f} ms{held}", flush=True)
                results.append({"rows": set_name, "variant": name, "ms": min(t),
                                "max_abs_err": err[name]})
    finally:
        mups_cuda.KERNEL._lib = served
    return results


if __name__ == "__main__":
    main()
