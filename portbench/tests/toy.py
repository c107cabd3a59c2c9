"""Toy sizes of the benchmark's cells, for rehearsals on the CPU: the
cells' own files with the widths cut (a one-block backbone for the
mixture of experts, the 3^3 grid's backbone for the MS network), 3^3
Gaussians, 64 points a patch, two shapes of 3,000 points with 40 queries
each (20 in the warm-up), batches of 16."""

from __future__ import annotations

import copy

from portbench import harness

TINY = [["incep", 8, [1, 2]], ["maxpool", 2, 2]]
CONV_NET_3G = [["incep", 128, [2, 3]], ["incep", 256, [2, 3]], ["incep", 256, [1, 2]],
               ["incep", 512, [1, 2]], ["maxpool", 3, 2]]


def spec(cell: str, check_samples: int = 48) -> dict:
    s = copy.deepcopy(harness.cell_spec(cell, harness.benchmark()))
    cfg, tr = s["config"], s["traffic"]
    cfg.update(num_point=64, num_gaussians=3)
    if cfg["model"] == "experts_n_est":
        cfg["tiny_backbone"] = True
        cfg["manager"]["backbone"] = TINY
        cfg["expert"]["backbone"] = TINY
    else:
        cfg["net"]["backbone"] = CONV_NET_3G
    tr.update(points_per_shape=3000, queries_per_shape=40, batch_size=16,
              warm_queries_per_shape=20)
    tr["shapes"] = tr["shapes"][3:5]
    s["cell"]["check_samples"] = check_samples
    return s
