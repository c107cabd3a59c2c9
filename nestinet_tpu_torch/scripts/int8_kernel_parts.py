"""Where the int8 kernels' time goes: each kernel timed with one part of its
work switched off at a time.

    python -m nestinet_tpu_torch.scripts.int8_kernel_parts [--out DIR] [--kernel NAME]

On the card only.  `csrc/int8_conv.cu` holds a compile-time switch (the
PART_* macros) around each part of `int8_conv3d_direct_kernel` (the halo
fill, the wgmma, the weights' TMA stream) and around two tuning constants;
`csrc/int8_gemm.cu` around each part of `int8_gemm_kernel` (the
activation's TMA, the quantize into A fragments, the weights' TMA, the
wgmma, the split-K cluster sum, the epilogue's stores) and around its
ring depth.  This script builds every
variant with the library's own nvcc flags, all at once, and times each at
flagship shapes that run that kernel (CUDA events, the median of 20 calls,
the variants in one order and then the reverse; the lower of the two is
printed), beside the time of one read of the activation (its sum, the
memory's yardstick) and `torch._int_mm` on the int8 operands at the GEMM's
shapes.  A variant with a part switched off computes garbage: the times
say what the rest costs, nothing else.  The libraries the port serves with
are not touched.
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
GEMM_VARIANTS = {
    "full": [],
    "no A stream": ["-DPART_NO_A"],
    "no quantize": ["-DPART_NO_QUANT"],
    "no B stream": ["-DPART_NO_B"],
    "no mma": ["-DPART_NO_MMA"],
    "no cluster sum": ["-DPART_NO_SUM"],
    "no epilogue": ["-DPART_NO_EPILOGUE"],
    "no A, no B": ["-DPART_NO_A", "-DPART_NO_B"],
    "no quantize, no mma": ["-DPART_NO_QUANT", "-DPART_NO_MMA"],
    "ring of 3": ["-DPART_RING=3"],
    "A from L2": ["-DPART_A_L2"],
}
# (B, cin, cout, k, r).  The direct kernel: the widest conv, the 5^3 and 3^3
# convs, the widest at a routed sub-batch.  The GEMM: the widest 1x1x1
# convs at r = 8, 4 and 2, the first conv of the 126-channel expert, the
# widest linear, each at B = 256, and the r = 2 conv at B = 37.
SHAPES = ((256, 256, 128, 5, 8), (256, 128, 64, 5, 8), (256, 256, 128, 3, 8),
          (37, 256, 128, 5, 8))
GEMM_SHAPES = ((256, 768, 256, 1, 8), (256, 384, 256, 1, 8), (256, 126, 256, 1, 8),
               (256, 1536, 512, 1, 4), (256, 1536, 512, 1, 2), (37, 1536, 512, 1, 2),
               (256, 1536, 1024, 1, 1))
KERNELS = {"int8_conv": (int8_cuda.KERNEL, VARIANTS, SHAPES),
           "int8_gemm": (int8_cuda.GEMM, GEMM_VARIANTS, GEMM_SHAPES)}


def build_variants(out_dir: str, name: str) -> dict:
    """One library per variant of kernel `name`, one nvcc each, all started
    together."""
    kernel, variants, _ = KERNELS[name]
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build._nvcc()

    def make(i_flags):
        i, flags = i_flags
        path = os.path.join(out_dir, f"{name}_variant{i}.so")
        proc = subprocess.run([nvcc, *build.NVCC_FLAGS, *flags, "-o", path, kernel.source],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {flags}:\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(path)
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        return lib

    with ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(make, enumerate(variants.values())))
    return dict(zip(variants, libs))


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


def yardsticks(x, w_q, x_amax, k) -> dict:
    """One read of the activation (its float32 sum) and, at k = 1, `torch._int_mm`
    on the int8 operands (the quantized activation channels-last, w_q^T)."""
    from ..ops import quant

    out = {"read x": cuda_median_ms(lambda: x.sum(dtype=torch.float32), warmup=3, iters=20)}
    if k == 1:
        B = x.shape[0]
        a = quant.quantize_activation(x, quant.activation_scale(x, x_amax)).reshape(
            B * x[0, 0].numel(), -1)
        w = w_q[:, 0, :].t()
        out["torch._int_mm"] = cuda_median_ms(lambda: torch._int_mm(a, w), warmup=3,
                                              iters=20)
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR, "int8_parts"),
                    help="directory for the variant libraries")
    ap.add_argument("--kernel", choices=sorted(KERNELS), action="append",
                    help="the kernel to take apart (default: both)")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    rows = []
    for name in args.kernel or sorted(KERNELS):
        kernel, _, shapes = KERNELS[name]
        libs = build_variants(args.out, name)
        served = kernel._lib
        try:
            for B, cin, cout, k, r in shapes:
                x, w_q, s_w, b, bound = operands(gen, dev, B, cin, cout, k, r)
                ops = 2.0 * B * r ** 3 * cout * k ** 3 * cin
                ms = {v: [] for v in libs}
                for order in (list(libs), list(libs)[::-1]):
                    for v in order:
                        kernel._lib = libs[v]
                        ms[v].append(cuda_median_ms(lambda: int8_cuda.int8_conv3d_cuda(
                            x, w_q, s_w, b, k, bound, relu=True, want_amax=True), warmup=3,
                            iters=20))
                print(f"{name} [B={B}, cin={cin}, cout={cout}, k={k}, r={r}] [{card}]",
                      flush=True)
                for v, t in ms.items():
                    print(f"  {v:18s} {min(t):.4f} ms  {ops / min(t) / 1e9:7.1f} TOPS",
                          flush=True)
                    rows.append({"kernel": name, "shape": [B, cin, cout, k, r], "variant": v,
                                 "ms": min(t)})
                for v, t in yardsticks(x, w_q, bound, k).items():
                    print(f"  {v:18s} {t:.4f} ms", flush=True)
                    rows.append({"kernel": name, "shape": [B, cin, cout, k, r], "variant": v,
                                 "ms": t})
        finally:
            kernel._lib = served
    return rows


if __name__ == "__main__":
    main()
