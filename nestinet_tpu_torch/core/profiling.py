"""Step timing.

`StepTimer` of `nestinet_tpu/core/profiling.py` (`:115-150`).  PyTorch
returns before the card finishes, so on a CUDA device the timer
synchronizes it at the start and at the end of each step: a step's time
is then the card's, not the enqueue's.  The device trace (`trace()`) is
not ported yet.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


class StepTimer:
    """Wall-clock step timer with percentile aggregation.

    Usage:
        timer = StepTimer(device)
        with timer.step():
            ... one train step ...
        stats = timer.summary()   # {"steps", "mean_ms", "p50_ms", ...}
    """

    def __init__(self, device: torch.device | None = None):
        self._times_s: list[float] = []
        self._sync = device is not None and torch.device(device).type == "cuda"
        self._device = device

    @contextlib.contextmanager
    def step(self):
        if self._sync:
            torch.cuda.synchronize(self._device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize(self._device)
            self._times_s.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        if not self._times_s:
            return {"steps": 0}
        t = np.asarray(self._times_s) * 1e3
        return {
            "steps": int(t.size),
            "mean_ms": float(t.mean()),
            "p50_ms": float(np.percentile(t, 50)),
            "p90_ms": float(np.percentile(t, 90)),
            "p99_ms": float(np.percentile(t, 99)),
            "total_s": float(t.sum() / 1e3),
        }
