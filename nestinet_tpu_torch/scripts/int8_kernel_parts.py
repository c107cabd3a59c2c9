"""Where the int8 conv kernel's time goes: the direct kernel timed with one
part of its work switched off at a time.

    python -m nestinet_tpu_torch.scripts.int8_kernel_parts [--out DIR]

On the card only.  `csrc/int8_conv.cu` holds a compile-time switch (the
PART_* macros) around each part of `int8_conv3d_direct_kernel` (the halo
fill, the wgmma, the weights' TMA stream) and around two tuning constants.
This script builds every variant with the library's own nvcc flags, all at
once, and times each at the flagship shapes that run the direct kernel
(CUDA events, the median of 20 calls, the variants in one order and then
the reverse; the lower of the two is printed).  A variant with a part switched off
computes garbage: the times say what the rest costs, nothing else.  The
library the port serves with is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..core.device import cuda_median_ms
from ..ops.kernels import build, int8_cuda

VARIANTS = {
    "full": [],
    "no fill": ["-DPART_NO_FILL"],
    "no mma": ["-DPART_NO_MMA"],
    "no B stream": ["-DPART_NO_B"],
    "no fill, no B": ["-DPART_NO_FILL", "-DPART_NO_B"],
    "1 group in flight": ["-DPART_IN_FLIGHT=1"],
    "4 taps per stage": ["-DPART_TAPS_PER_STAGE=4"],
}
# (B, cin, cout, k, r): the widest conv, the 5^3 and 3^3 convs, two 1x1x1 convs
SHAPES = ((256, 256, 128, 5, 8), (256, 128, 64, 5, 8), (256, 256, 128, 3, 8),
          (256, 768, 256, 1, 8), (256, 384, 256, 1, 8))


def build_variants(out_dir: str) -> dict:
    """One library per variant, one nvcc each, all started together."""
    os.makedirs(out_dir, exist_ok=True)
    src = int8_cuda.KERNEL.source
    nvcc = build._nvcc()

    def make(i_flags):
        i, flags = i_flags
        path = os.path.join(out_dir, f"variant{i}.so")
        proc = subprocess.run([nvcc, *build.NVCC_FLAGS, *flags, "-o", path, src],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {flags}:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(path)
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        return lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(make, enumerate(VARIANTS.values())))
    return dict(zip(VARIANTS, libs))


def operands(gen, dev, B, cin, cout, k, r):
    """A bf16 activation N(0, 2^2), int8 weights, scales, bias and a bound."""
    from ..ops.quant import padded_channels

    cin_p = padded_channels(cin)
    x = (torch.randn((B, cin, r, r, r), generator=gen) * 2).to(torch.bfloat16)
    w_q = torch.zeros((cout, k ** 3, cin_p), dtype=torch.int8)
    w_q[..., :cin] = torch.randint(-127, 128, (cout, k ** 3, cin), generator=gen,
                                   dtype=torch.int8)
    s_w = (torch.rand(cout, generator=gen) + 0.5) * 1e-3
    b = torch.randn(cout, generator=gen)
    return [t.to(dev) for t in (x, w_q, s_w, b, x.abs().amax().float() * 1.25)]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR, "int8_parts"),
                    help="directory for the variant libraries")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    libs = build_variants(args.out)
    gen = torch.Generator().manual_seed(7)
    rows = []
    served = int8_cuda.KERNEL._lib
    try:
        for B, cin, cout, k, r in SHAPES:
            x, w_q, s_w, b, bound = operands(gen, dev, B, cin, cout, k, r)
            ops = 2.0 * B * r ** 3 * cout * k ** 3 * cin
            ms = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    int8_cuda.KERNEL._lib = libs[name]
                    ms[name].append(cuda_median_ms(lambda: int8_cuda.int8_conv3d_cuda(
                        x, w_q, s_w, b, k, bound, relu=True, want_amax=True), warmup=3,
                        iters=20))
            print(f"[B={B}, cin={cin}, cout={cout}, k={k}, r={r}] [{card}]", flush=True)
            for name, t in ms.items():
                print(f"  {name:18s} {min(t):.4f} ms  {ops / min(t) / 1e9:7.1f} TOPS", flush=True)
                rows.append({"shape": [B, cin, cout, k, r], "variant": name, "ms": min(t)})
    finally:
        int8_cuda.KERNEL._lib = served
    return rows


if __name__ == "__main__":
    main()
