"""How far float32 gradients of the full-width train step move with the
order of their sums, on the card and on the CPU (card only).

    python -m nestinet_tpu_torch.scripts.train_step_precision

Run from the root of a checkout.  One float32 train step of the full-width
flagship (`chip_smoke.py`'s weights from its seed, one batch of 16 patches
at PCPNet's density with random normals) is taken on the CPU with 8
threads as the reference, and again: on the CPU with 1 thread; on the CPU
with the input points moved by 1e-7 and by 1e-6 relative (about one and
eight float32 ulps); on the card with the MuPS kernel (the port's path),
with the plain MuPS on the card, and with cuDNN switched off.  Each line
gives the loss's relative error, each gradient tensor's relative L2 error
(the worst, the median, how many exceed 1e-4) and all gradients' at once,
against the reference.  `chip_smoke.py` phase 13a holds the card to 4x the
1e-7 perturbation's spread, measured in its own run.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import time


def main() -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as smoke
    from nestinet_tpu_torch.core.config import Config
    from nestinet_tpu_torch.core.device import resolve_device, set_f32_numerics
    from nestinet_tpu_torch.models import build_model
    from nestinet_tpu_torch.ops import mups as mups_ops
    from nestinet_tpu_torch.ops.gmm import get_3d_grid_gmm
    from nestinet_tpu_torch.ops.kernels import mups_cuda

    dev = resolve_device("cuda")
    set_f32_numerics()
    card = smoke.gpu_line()
    gmm = get_3d_grid_gmm([8, 8, 8], variance=0.0156)
    cfg = Config(model="experts_n_est", patch_radius=(0.01, 0.03, 0.05), num_point=512,
                 num_gaussians=8, n_experts=smoke.N_EXPERTS, seed=smoke.SEED)
    base = build_model(cfg, gmm, torch.Generator().manual_seed(smoke.SEED))
    noisy = smoke.bn_fed_biases(base)
    batch = smoke.training_batch(dev, smoke.TRAIN_CHECK_BATCH, smoke.SEED)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}

    def step(on_card: bool, b):
        model = copy.deepcopy(base)
        return smoke.step_gradients(model.to(dev) if on_card else model, cfg, b)

    threads = torch.get_num_threads()
    ref_loss, ref = step(False, cpu_batch)
    rows = {}

    def row(name, result):
        loss, grads = result
        e = smoke.gradient_errors(grads, ref, noisy)
        errs = sorted(e["by_tensor"].values())
        rows[name] = {"loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                      "worst": e["worst"], "median": errs[len(errs) // 2],
                      "over_1e-4": sum(x > 1e-4 for x in errs), "all": e["all"],
                      "bn_fed_bias": e["bias"]}
        r = rows[name]
        print(f"{name}: loss {r['loss_rel_err']:.2e}; gradients worst {r['worst'][1]:.2e} "
              f"({r['worst'][0]}), median {r['median']:.2e}, {r['over_1e-4']} of "
              f"{len(errs)} over 1e-4, all {r['all']:.2e} [{card}]", flush=True)

    torch.set_num_threads(1)
    row("CPU, 1 thread", step(False, cpu_batch))
    torch.set_num_threads(threads)
    for rel in (1e-7, 1e-6):
        row(f"CPU, points moved by {rel:g}", step(False, smoke.perturbed(cpu_batch, rel, 1)))
    row("card, MuPS kernel", step(True, batch))
    kernel = mups_cuda.tdmfv_n_est_cuda
    mups_cuda.tdmfv_n_est_cuda = mups_ops.tdmfv_n_est_reference
    try:
        row("card, plain MuPS", step(True, batch))
    finally:
        mups_cuda.tdmfv_n_est_cuda = kernel
    with torch.backends.cudnn.flags(enabled=False):
        row("card, no cuDNN", step(True, batch))
    return rows


if __name__ == "__main__":
    t0 = time.perf_counter()
    out = main()
    print(f"took {time.perf_counter() - t0:.1f} s")
    print(json.dumps(out, default=str))
