"""Device resolution, float32 numerics and timing on the card.

No fallback hides the device: `"cuda"` (the default) raises when no GPU is
present, and the CPU is used only when a caller asks for it by name, as the
CPU tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The torch device to run on; raises rather than fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {dev}")
    return dev


def set_f32_numerics() -> None:
    """Full float32 for convolutions and matrix products.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); the JAX reference computes in float32, so the serving path
    turns TF32 off for both cuDNN and cuBLAS.
    """
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def cuda_median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median milliseconds of `fn()` on the current CUDA stream, by CUDA
    events around each call, after `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]
