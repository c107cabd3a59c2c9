"""The benchmark's one traffic generator: PCPNet-protocol shapes from a
seed, written as the program reads them (`<shape>.xyz`, `<shape>.pidx`,
`<list>.txt`).

A copy of the analytic shapes and the PCPNet transforms of the program's
`data/synthetic.py::build_protocol_benchmark` (white noise of sigma x
the bounding-box diagonal; a density gradient and stripes along x), driven
by a traffic file of `portbench/traffic/`: which base shape in which
variant, how many points and queries.  Every seed gives the same list of
sizes; only the draws differ.
"""

from __future__ import annotations

import os
import zlib

import numpy as np


def sphere(n, rng):
    v = rng.randn(n, 3)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def ellipsoid(n, rng, abc=(1.0, 0.7, 0.45)):
    return sphere(n, rng) * np.asarray(abc)


def plane(n, rng):
    pts = np.zeros((n, 3))
    pts[:, :2] = rng.uniform(-1, 1, (n, 2))
    return pts


def torus(n, rng, R=0.7, r=0.3):
    u = rng.uniform(0, 2 * np.pi, 2 * n)
    v = rng.uniform(0, 2 * np.pi, 2 * n)
    keep = rng.uniform(0, 1, 2 * n) < (R + r * np.cos(v)) / (R + r)
    u, v = u[keep][:n], v[keep][:n]
    while u.shape[0] < n:
        u2 = rng.uniform(0, 2 * np.pi, n)
        v2 = rng.uniform(0, 2 * np.pi, n)
        k2 = rng.uniform(0, 1, n) < (R + r * np.cos(v2)) / (R + r)
        u = np.concatenate([u, u2[k2]])[:n]
        v = np.concatenate([v, v2[k2]])[:n]
    return np.stack([(R + r * np.cos(v)) * np.cos(u), (R + r * np.cos(v)) * np.sin(u),
                     r * np.sin(v)], 1)


def cylinder(n, rng, radius=0.5, height=2.0):
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-height / 2, height / 2, n)
    return np.stack([radius * np.cos(theta), radius * np.sin(theta), z], 1)


def saddle(n, rng, a=0.6):
    xy = rng.uniform(-1, 1, (n, 2))
    return np.concatenate([xy, a * (xy[:, :1] ** 2 - xy[:, 1:] ** 2)], 1)


def ripple(n, rng, amp=0.25, freq=2.5):
    xy = rng.uniform(-1, 1, (n, 2))
    z = amp * np.sin(freq * xy[:, 0]) * np.cos(freq * xy[:, 1])
    return np.concatenate([xy, z[:, None]], 1)


def box(n, rng, half=0.8):
    face = rng.randint(0, 6, n)
    uv = rng.uniform(-half, half, (n, 2))
    pts = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        axis, sign = divmod(f, 2)
        others = [i for i in range(3) if i != axis]
        pts[m, axis] = half if sign == 0 else -half
        pts[m, others[0]] = uv[m, 0]
        pts[m, others[1]] = uv[m, 1]
    return pts


def cone(n, rng, radius=0.8, height=1.2):
    t = np.sqrt(rng.uniform(0, 1, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    r = radius * t
    return np.stack([r * np.cos(theta), r * np.sin(theta), height * (1 - t)], 1)


SHAPES = {"sphere": sphere, "ellipsoid": ellipsoid, "plane": plane, "torus": torus,
          "cylinder": cylinder, "saddle": saddle, "ripple": ripple, "box": box, "cone": cone}


def _bbdiag(pts):
    return float(np.linalg.norm(pts.max(0) - pts.min(0)))


def variant(pts, name: str, traffic: dict, rng):
    """The PCPNet variant `name` of a clean shape."""
    if name == "clean":
        return pts
    if name.startswith("whitenoise_"):
        sigma = traffic["noise_levels"][name.split("_", 1)[1]]
        return pts + sigma * _bbdiag(pts) * rng.randn(*pts.shape)
    x = pts[:, 0]
    t = (x - x.min()) / max(x.max() - x.min(), 1e-12)
    dens = traffic["density"]
    if name == "vardensity_gradient":
        p = 1.0 - (1.0 - dens["gradient_min_keep"]) * t
    elif name == "vardensity_striped":
        band = np.floor(t * dens["stripe_bands"]).astype(int)
        p = np.where(band % 2 == 0, 1.0, dens["stripe_low_keep"])
    else:
        raise ValueError(f"unknown variant {name!r}")
    # keep probability p per point, with the kept count fixed at round(sum p)
    # so that every seed serves clouds of the same sizes
    keep = np.argsort(rng.uniform(0, 1, pts.shape[0]) / p, kind="stable")
    return pts[np.sort(keep[:int(round(p.sum()))])]


def write_list(root: str, list_name: str, traffic: dict, seed: int) -> dict:
    """Write the traffic's shapes under `root` and the list `<list_name>.txt`;
    returns {"names", "clouds" (float32, as the program parses the text),
    "queries" (int64 indices)}."""
    os.makedirs(root, exist_ok=True)
    n, n_q = traffic["points_per_shape"], traffic["queries_per_shape"]
    names, clouds, queries = [], [], []
    for i, s in enumerate(traffic["shapes"]):
        key = zlib.crc32(f"{s['base']}/{s['variant']}/{i}/{seed}".encode()) & 0x7FFFFFFF
        rng = np.random.RandomState(key)
        pts = variant(SHAPES[s["base"]](n, rng), s["variant"], traffic, rng)
        name = f"{s['base']}_{s['variant']}"
        xyz = os.path.join(root, name + ".xyz")
        np.savetxt(xyz, pts, fmt="%.8f")
        pidx = rng.choice(pts.shape[0], size=min(n_q, pts.shape[0]), replace=False)
        np.savetxt(os.path.join(root, name + ".pidx"), pidx, fmt="%i")
        names.append(name)
        clouds.append(np.loadtxt(xyz).astype(np.float32))
        queries.append(pidx.astype(np.int64))
    with open(os.path.join(root, list_name + ".txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return {"names": names, "clouds": clouds, "queries": queries}
