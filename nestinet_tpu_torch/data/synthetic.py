"""Analytic synthetic shapes + a PCPNet-protocol benchmark generator.

A copy of `nestinet_tpu/data/synthetic.py`, the switching-regime benchmark
that the noise-switching model trains on included, so that the port
imports nothing of the JAX package.

The canonical quality protocol is PCPNet's: six testsets (clean,
three white-noise levels, two variable-density resamplings), 5000
eval points per shape from `.pidx`, unoriented RMS / PGP5 / PGP10
(the reference's `utils/evaluate.py:21,40-41,139-151`).  The real
PCPNet download is unreachable from this machine (zero network egress
— see QUALITY.md), so this module synthesizes a *protocol-identical*
benchmark from analytic surfaces whose ground-truth normals are exact
(no estimation error in the labels, unlike the real scans).

Noise and density follow the PCPNet construction:
  * white noise: x += sigma * bbox_diagonal * N(0, I), GT normals stay
    those of the clean surface point (sigma in {0.00125, 0.006, 0.012}
    for small/medium/large, matching the testset names);
  * vardensity gradient: keep probability ramps linearly 1.0 -> 0.05
    along one axis;
  * vardensity striped: alternating high/low keep-probability bands.

Every generator returns (points [N,3], normals [N,3]) with unit
normals; shapes span flat, curved, mixed-curvature and sharp-edge
regimes so the multi-scale MoE has genuine scale structure to learn.
"""

from __future__ import annotations

import os

import numpy as np

# ---------------------------------------------------------------- shapes


def plane(n, rng):
    pts = np.zeros((n, 3))
    pts[:, :2] = rng.uniform(-1, 1, (n, 2))
    nrm = np.tile([0.0, 0.0, 1.0], (n, 1))
    return pts, nrm


def sphere(n, rng, radius=1.0):
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return radius * v, v


def ellipsoid(n, rng, abc=(1.0, 0.7, 0.45)):
    a, b, c = abc
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts = v * np.asarray(abc)
    nrm = pts / np.square(np.asarray(abc))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm


def torus(n, rng, R=0.7, r=0.3):
    # area-uniform: rejection on the (R + r cos v) Jacobian factor
    u = rng.uniform(0, 2 * np.pi, 2 * n)
    v = rng.uniform(0, 2 * np.pi, 2 * n)
    keep = rng.uniform(0, 1, 2 * n) < (R + r * np.cos(v)) / (R + r)
    u, v = u[keep][:n], v[keep][:n]
    while u.shape[0] < n:  # top up (rare)
        u2 = rng.uniform(0, 2 * np.pi, n)
        v2 = rng.uniform(0, 2 * np.pi, n)
        k2 = rng.uniform(0, 1, n) < (R + r * np.cos(v2)) / (R + r)
        u = np.concatenate([u, u2[k2]])[:n]
        v = np.concatenate([v, v2[k2]])[:n]
    cx = (R + r * np.cos(v)) * np.cos(u)
    cy = (R + r * np.cos(v)) * np.sin(u)
    cz = r * np.sin(v)
    nrm = np.stack([np.cos(v) * np.cos(u), np.cos(v) * np.sin(u), np.sin(v)], 1)
    return np.stack([cx, cy, cz], 1), nrm


def cylinder(n, rng, radius=0.5, height=2.0):
    """Open cylinder side wall; normals radial."""
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-height / 2, height / 2, n)
    pts = np.stack([radius * np.cos(theta), radius * np.sin(theta), z], 1)
    nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], 1)
    return pts, nrm


def saddle(n, rng, a=0.6):
    """Graph z = a (x^2 - y^2): smooth, mixed (negative) curvature."""
    xy = rng.uniform(-1, 1, (n, 2))
    z = a * (xy[:, 0] ** 2 - xy[:, 1] ** 2)
    nrm = np.stack([-2 * a * xy[:, 0], 2 * a * xy[:, 1], np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([xy, z[:, None]], 1), nrm


def ripple(n, rng, amp=0.25, freq=2.5):
    """Graph z = amp sin(freq x) cos(freq y): oscillating curvature."""
    xy = rng.uniform(-1, 1, (n, 2))
    x, y = xy[:, 0], xy[:, 1]
    z = amp * np.sin(freq * x) * np.cos(freq * y)
    dzdx = amp * freq * np.cos(freq * x) * np.cos(freq * y)
    dzdy = -amp * freq * np.sin(freq * x) * np.sin(freq * y)
    nrm = np.stack([-dzdx, -dzdy, np.ones(n)], 1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([xy, z[:, None]], 1), nrm


def box(n, rng, half=0.8):
    """Axis-aligned cube surface: flat faces meeting at sharp edges —
    the regime where small-radius experts must win."""
    # faces weighted by (equal) area
    face = rng.randint(0, 6, n)
    uv = rng.uniform(-half, half, (n, 2))
    pts = np.zeros((n, 3))
    nrm = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        axis, sign = divmod(f, 2)
        sign = 1.0 if sign == 0 else -1.0
        others = [i for i in range(3) if i != axis]
        pts[m, axis] = sign * half
        pts[m, others[0]] = uv[m, 0]
        pts[m, others[1]] = uv[m, 1]
        nrm[m, axis] = sign
    return pts, nrm


def capped_cone(n, rng, radius=0.8, height=1.2):
    """Cone side wall (apex up); normals analytic away from the apex."""
    # area-uniform in side coordinate: r ~ sqrt(U)
    t = np.sqrt(rng.uniform(0, 1, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    r = radius * t
    z = height * (1 - t)
    slope = radius / height
    nrm = np.stack(
        [np.cos(theta), np.sin(theta), np.full(n, slope)], 1
    )
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], 1), nrm


SHAPE_GENERATORS = {
    "plane": plane,
    "sphere": sphere,
    "ellipsoid": ellipsoid,
    "torus": torus,
    "cylinder": cylinder,
    "saddle": saddle,
    "ripple": ripple,
    "box": box,
    "cone": capped_cone,
}

# ------------------------------------------------ PCPNet-style transforms

# sigma/bbox-diagonal factors behind the canonical testset names
NOISE_LEVELS = {"small": 0.00125, "medium": 0.006, "large": 0.012}


def bbox_diagonal(pts: np.ndarray) -> float:
    return float(np.linalg.norm(pts.max(0) - pts.min(0)))


def add_white_noise(pts, sigma_frac, rng):
    """Perturb points by sigma_frac * bbox diagonal of isotropic noise;
    GT normals remain those of the clean surface points (PCPNet
    convention)."""
    return pts + sigma_frac * bbox_diagonal(pts) * rng.randn(*pts.shape)


def density_gradient(pts, nrm, rng, min_keep=0.05):
    """Keep probability ramps linearly 1.0 -> min_keep along x."""
    x = pts[:, 0]
    t = (x - x.min()) / max(x.max() - x.min(), 1e-12)
    keep = rng.uniform(0, 1, pts.shape[0]) < (1.0 - (1.0 - min_keep) * t)
    return pts[keep], nrm[keep]


def density_striped(pts, nrm, rng, n_bands=8, low_keep=0.08):
    """Alternating high/low keep-probability bands along x."""
    x = pts[:, 0]
    t = (x - x.min()) / max(x.max() - x.min(), 1e-12)
    band = np.floor(t * n_bands).astype(int)
    p = np.where(band % 2 == 0, 1.0, low_keep)
    keep = rng.uniform(0, 1, pts.shape[0]) < p
    return pts[keep], nrm[keep]


# ---------------------------------------------------------- the benchmark

TRAIN_SHAPES = ["sphere", "plane", "torus", "saddle", "ripple", "cylinder"]
VAL_SHAPES = ["ellipsoid", "cone"]
TEST_SHAPES = ["sphere", "torus", "box", "saddle", "ripple", "cone"]

TESTSETS = [
    "testset",
    "testset_whitenoise_small",
    "testset_whitenoise_medium",
    "testset_whitenoise_large",
    "testset_vardensity_gradient",
    "testset_vardensity_striped",
]


def _write_shape(root, name, pts, nrm, n_pidx, rng):
    np.savetxt(os.path.join(root, name + ".xyz"), pts, fmt="%.8f")
    np.savetxt(os.path.join(root, name + ".normals"), nrm, fmt="%.8f")
    pidx = rng.choice(pts.shape[0], size=min(n_pidx, pts.shape[0]), replace=False)
    np.savetxt(os.path.join(root, name + ".pidx"), pidx, fmt="%i")


def build_protocol_benchmark(
    root: str,
    n_points: int = 50_000,
    n_pidx: int = 5_000,
    seed: int = 11,
) -> dict:
    """Materialize the full PCPNet-protocol directory under `root`.

    Writes train/validation lists (clean + medium + large noise copies
    of each training shape, mirroring `trainingset_whitenoise.txt`'s
    mixed-noise composition) and the six canonical testsets.  Returns
    {list_name: [shape names]}.
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    sets: dict[str, list] = {}

    def gen(name, n=n_points, salt=0):
        # crc32, not hash(): Python's str hash is randomized per process
        # (PYTHONHASHSEED), which would silently make the "seeded"
        # benchmark irreproducible across runs/hosts.
        import zlib

        key = zlib.crc32(f"{name}/{salt}/{seed}".encode()) & 0x7FFFFFFF
        r = np.random.RandomState(key)
        return SHAPE_GENERATORS[name](n, r)

    # train / val: clean + noisy copies (GT normals of the clean points)
    for list_name, bases, salt in (
        ("trainingset_whitenoise.txt", TRAIN_SHAPES, 1),
        ("validationset.txt", VAL_SHAPES, 2),
    ):
        names = []
        noise_of = {}
        for base in bases:
            pts, nrm = gen(base, salt=salt)
            variants = {
                f"{base}{salt}": (pts, 0.0),
                f"{base}{salt}_noise_med": (
                    add_white_noise(pts, NOISE_LEVELS["medium"], rng),
                    NOISE_LEVELS["medium"],
                ),
                f"{base}{salt}_noise_lrg": (
                    add_white_noise(pts, NOISE_LEVELS["large"], rng),
                    NOISE_LEVELS["large"],
                ),
            }
            for vname, (vpts, sigma) in variants.items():
                _write_shape(root, vname, vpts, nrm, n_pidx, rng)
                names.append(vname)
                noise_of[vname] = sigma
        with open(os.path.join(root, list_name), "w") as f:
            f.write("\n".join(names) + "\n")
        # per-shape noise sigmas for the noise-switching trainer
        # (`<list>_noise_levels.txt`, parity: pcpnet_dataset.py:223-233
        # and README.md:60 of the reference)
        with open(
            os.path.join(root, list_name[:-4] + "_noise_levels.txt"), "w"
        ) as f:
            f.write("\n".join(f"{noise_of[n]:.6f}" for n in names) + "\n")
        sets[list_name] = names

    # six canonical testsets over the SAME base test shapes
    base_test = {}
    for base in TEST_SHAPES:
        base_test[base] = gen(base, salt=3)

    for ts in TESTSETS:
        names = []
        for base, (pts, nrm) in base_test.items():
            if ts == "testset":
                vpts, vnrm, suffix = pts, nrm, ""
            elif ts.startswith("testset_whitenoise_"):
                lvl = ts.rsplit("_", 1)[1]
                vpts = add_white_noise(pts, NOISE_LEVELS[lvl], rng)
                vnrm, suffix = nrm, f"_wn_{lvl}"
            elif ts == "testset_vardensity_gradient":
                vpts, vnrm = density_gradient(pts, nrm, rng)
                suffix = "_vd_grad"
            else:
                vpts, vnrm = density_striped(pts, nrm, rng)
                suffix = "_vd_stripe"
            name = f"{base}_t{suffix}"
            _write_shape(root, name, vpts, vnrm, n_pidx, rng)
            names.append(name)
        with open(os.path.join(root, ts + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
        sets[ts + ".txt"] = names
    return sets

# ------------------------------------------- switching-regime benchmark

# Noise sigmas straddling the reference's hard-switch threshold
# (`ms_sw_n_est.py:82`: small-scale branch iff noise_est < 0.015).  The
# canonical PCPNet levels all sit BELOW 0.015, so on the protocol
# benchmark above the trained switch routes every sample one way and the
# mechanism is never observed to fire (QUALITY.md "Why the switching
# ablation stalls").  This regime puts levels on both sides so a correct
# noise head must drive traffic through BOTH branches.
SWITCH_NOISE_LEVELS = (0.0, 0.005, 0.01, 0.02, 0.03)


def build_switching_benchmark(
    root: str,
    n_points: int = 50_000,
    n_pidx: int = 5_000,
    seed: int = 23,
) -> dict:
    """Materialize a noise-switching demonstration dataset under `root`.

    Same file/list contract as `build_protocol_benchmark` (the noise
    trainer reads per-shape sigmas from `<list>_noise_levels.txt`,
    parity: `pcpnet_dataset.py:223-233`), but every list carries each
    base shape at all of `SWITCH_NOISE_LEVELS` — three below and two
    above the 0.015 switch threshold.  Lists written:
    `trainingset_switching.txt`, `validationset_switching.txt`,
    `testset_switching.txt` (+ their `_noise_levels.txt`).
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    sets: dict[str, list] = {}

    def gen(name, salt):
        import zlib

        key = zlib.crc32(f"sw/{name}/{salt}/{seed}".encode()) & 0x7FFFFFFF
        r = np.random.RandomState(key)
        return SHAPE_GENERATORS[name](n_points, r)

    for list_name, bases, salt in (
        ("trainingset_switching.txt", TRAIN_SHAPES, 1),
        ("validationset_switching.txt", VAL_SHAPES, 2),
        ("testset_switching.txt", TEST_SHAPES, 3),
    ):
        names, noise_of = [], {}
        for base in bases:
            pts, nrm = gen(base, salt)
            for sigma in SWITCH_NOISE_LEVELS:
                vname = f"{base}{salt}_sw{int(round(sigma * 1000)):03d}"
                vpts = add_white_noise(pts, sigma, rng) if sigma else pts
                _write_shape(root, vname, vpts, nrm, n_pidx, rng)
                names.append(vname)
                noise_of[vname] = sigma
        with open(os.path.join(root, list_name), "w") as f:
            f.write("\n".join(names) + "\n")
        with open(
            os.path.join(root, list_name[:-4] + "_noise_levels.txt"), "w"
        ) as f:
            f.write("\n".join(f"{noise_of[n]:.6f}" for n in names) + "\n")
        sets[list_name] = names
    return sets
