"""Backbone layer specs for the 3D-Inception CNNs.

A copy of the specs in `nestinet_tpu/models/backbones.py`, which cannot be
imported without JAX (`nestinet_tpu/models/__init__.py` imports haiku).
They are data; tests/test_torch_experts.py and tests/test_torch_ablations.py
assert that the two copies are equal.  Each spec is a list of ("incep", n_filters, (k1, k2)) and
("maxpool", kernel, stride) entries consumed by `ops.nn.Backbone`.
"""


def incep(n, ks):
    return ("incep", n, ks)


def maxpool(k=2, s=2):
    return ("maxpool", k, s)


# Manager / gating CNN for 8^3 grids.
CONV_NET_8G = [
    incep(128, (3, 5)),
    incep(256, (3, 5)),
    incep(256, (3, 5)),
    maxpool(2, 2),
    incep(512, (2, 4)),
    incep(512, (2, 4)),
    maxpool(2, 2),
    incep(512, (1, 2)),
    maxpool(2, 2),
]

# Manager / gating CNN for 3^3 grids; also the 3^3 expert body.
CONV_NET_3G = [
    incep(128, (2, 3)),
    incep(256, (2, 3)),
    incep(256, (1, 2)),
    incep(512, (1, 2)),
    maxpool(3, 2),
]

# Single-scale model backbone (`ss_norm_est.py:52-66`).
SS_BACKBONE = [
    incep(128, (3, 5)),
    incep(256, (3, 5)),
    incep(256, (3, 5)),
    maxpool(2, 2),
    incep(512, (3, 5)),
    incep(512, (3, 5)),
    maxpool(2, 2),
]

# Multi-scale model backbone for 8^3 grids (`ms_norm_est.py:83-98`); at 3^3
# the multi-scale model runs CONV_NET_3G.
MS_BACKBONE_8G = [
    incep(128, (3, 5)),
    incep(256, (3, 5)),
    incep(256, (3, 5)),
    maxpool(2, 2),
    incep(512, (3, 4)),
    incep(512, (3, 4)),
    maxpool(2, 2),
]

# Noise-switching model CNN body, shared by the noise-estimation and both
# normal-estimation subnets (`ms_sw_n_est.py:138-200`).
SW_BACKBONE = [
    incep(128, (3, 5)),
    incep(256, (3, 5)),
    incep(256, (3, 5)),
    maxpool(2, 2),
    incep(512, (3, 5)),
    incep(512, (3, 5)),
    maxpool(2, 2),
]

# Single tiny inception block, substituted for every backbone of the mixture
# of experts when `cfg.tiny_backbone` is set (tests only; the ablation models
# ignore the flag, as in JAX).
TINY = [
    incep(8, (1, 2)),
    maxpool(2, 2),
]


def expert_backbone_8g(first_width: int):
    """Expert body for 8^3 grids; `first_width` is 128 // n_scales."""
    return [
        incep(first_width, (3, 5)),
        incep(256, (3, 5)),
        maxpool(2, 2),
        incep(256, (2, 4)),
        maxpool(2, 2),
        incep(512, (2, 4)),
        maxpool(2, 2),
    ]
