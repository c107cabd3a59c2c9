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


def pool_inputs(spec, cin: int, resolution: int) -> list:
    """(channels, resolution, kernel, stride) of the input of each max pool
    of `spec` run on [cin, resolution^3]: the shapes the pool kernel serves."""
    pools, c, r = [], cin, resolution
    for entry in spec:
        if entry[0] == "incep":
            c = 2 * entry[1] + 2 * (entry[1] // 2)  # Inception3D.out_channels
        else:
            pools.append((c, r, entry[1], entry[2]))
            r = -(-r // entry[2])
    return pools


def avg_pool_inputs(spec, cin: int, resolution: int) -> list:
    """(channels, resolution, kernel) of the input of each Inception block's
    stride-1 average pool of `spec` run on [cin, resolution^3] at inference:
    the block's input, or conv4's n channels where cin > n
    (`ops/nn.py::Inception3D`)."""
    pools, c, r = [], cin, resolution
    for entry in spec:
        if entry[0] == "incep":
            pools.append((min(c, entry[1]), r, entry[2][0]))
            c = 2 * entry[1] + 2 * (entry[1] // 2)  # Inception3D.out_channels
        else:
            r = -(-r // entry[2])
    return pools


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
