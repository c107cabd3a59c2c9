"""The serving driver: test-list jobs through the program's device serving
entry, one after another, and the comparison that decides `correct`.

A job is what one `cli.test --extraction=device --sparse_patches=1` call
pays: `predict_shapes_device` on the run dir and the test list, loading
the run dir, reading the clouds and writing every query's `.normals` row.
Set-up writes the shapes, makes the weights and writes the run dir, then
serves a short job over the same six clouds (the traffic's
`warm_queries_per_shape` queries of each), which builds and loads every
kernel and caches every cloud the window reads.  The window runs jobs back
to back from one client (a closed loop) and ends with the last job that
started before `seconds` had passed.

After the window, a sample of the answers drawn from the seed (job, shape,
query) is read back from the files and held to the reference
(`reference/`), which extracts the same patches, computes their
statistics, the manager's probabilities and every expert's normal in
float32 with TF32 off, from the benchmark's own clouds and weights.

The driver's interface, which `harness.py` finds by the cell's `driver`:
`run(spec, seed, seconds, trace, device, t_start, tmp, control)` and
`layer_context(spec, result)`.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from . import weights as wmod
from .reference import extract as ref_extract
from .reference import model as ref_model
from .reference import mups as ref_mups
from .traffic import generate

LIST = "portbench_list"
CHECK_BLOCK = 256


def program_config(cfg: dict, run_path: str):
    """The program's `Config` for the configuration file `cfg`."""
    from nestinet_tpu_torch.core.config import Config

    extra = {}
    if cfg["model"] == "experts_n_est":
        extra = dict(n_experts=cfg["n_experts"],
                     expert_dict={int(k): v for k, v in cfg["expert_dict"].items()})
    return Config(model=cfg["model"], log_dir=run_path, patch_radius=tuple(cfg["patch_radius"]),
                  num_point=cfg["num_point"], num_gaussians=cfg["num_gaussians"],
                  gmm_variance=cfg["gmm_variance"],
                  tiny_backbone=bool(cfg.get("tiny_backbone", False)), **extra)


def write_run_dir(cfg: dict, W: dict, run_path: str) -> None:
    """A run dir as the program's trainer leaves one: config.json, gmm.json
    and the float32 checkpoint of `W`."""
    import json

    from nestinet_tpu_torch.core import checkpoint

    os.makedirs(run_path, exist_ok=True)
    program_config(cfg, run_path).save(os.path.join(run_path, "config.json"))
    w, mu, sigma = ref_mups.grid_gmm(cfg["num_gaussians"], cfg["gmm_variance"])
    with open(os.path.join(run_path, "gmm.json"), "w") as f:
        json.dump({"weights": w.tolist(), "means": mu.tolist(),
                   "covariances": (sigma ** 2).tolist()}, f)
    checkpoint.save(run_path, {k: v.cpu() for k, v in W.items()})


def reference_grid(cfg, data, picks, serve_seed, batch, device):
    pts, n_eff = ref_extract.extract(data["clouds"], data["queries"], picks, cfg, serve_seed,
                                     batch)
    return ref_mups.statistics_grid(torch.from_numpy(pts).to(device),
                                    torch.from_numpy(n_eff).to(device), cfg)


def calibration_picks(data: dict, n: int) -> list:
    """n (shape, query) pairs, the first queries of every shape in turn."""
    sizes = [q.shape[0] for q in data["queries"]]
    picks = [(s, q) for q in range(max(sizes)) for s in range(len(sizes)) if q < sizes[s]]
    return sorted(picks[:n])


class Setup:
    """Inputs, weights and run dir of one run, under `tmp`."""

    def __init__(self, spec: dict, seed: int, tmp: str, device):
        from .harness import log

        cfg, traffic = spec["config"], spec["traffic"]
        self.spec, self.cfg, self.traffic, self.device = spec, cfg, traffic, device
        self.data_dir = os.path.join(tmp, "data")
        self.run_dir = os.path.join(tmp, "run")
        self.out_root = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        self.data = generate.write_list(self.data_dir, LIST, traffic, seed)
        t1 = time.perf_counter()
        W = wmod.make(cfg, seed, device)
        grid = reference_grid(cfg, self.data, calibration_picks(self.data, CHECK_BLOCK),
                              traffic["serve_seed"], traffic["batch_size"], device)
        t2 = time.perf_counter()
        spread = wmod.calibrate(cfg, W, grid)
        del grid
        if device.type == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        if spread:
            log(f"set-up: manager logits' std before the rescale {spread['z_std']}, "
                f"scales {spread['scale']}")
        write_run_dir(cfg, W, self.run_dir)
        log(f"set-up: shapes written in {t1 - t0:.3f} s; the reference's extraction of "
            f"{CHECK_BLOCK} calibration patches with the weights drawn {t2 - t1:.3f} s; "
            f"the reference's calibrating forward {t3 - t2:.3f} s; run dir written "
            f"{time.perf_counter() - t3:.3f} s")
        # the reference's copy waits on the host while the program runs
        self.W = {k: v.cpu() for k, v in W.items()}
        del W

    def warm_up(self, serve_opts: dict) -> dict:
        """A short job over the same clouds: each `.pidx` cut to its first
        `warm_queries_per_shape` queries while it runs, then written whole
        again, with the program's parsed copy of the cut one removed."""
        n = self.traffic["warm_queries_per_shape"]
        paths = [os.path.join(self.data_dir, name + ".pidx") for name in self.data["names"]]
        for path, q in zip(paths, self.data["queries"]):
            np.savetxt(path, q[:n], fmt="%i")
        warm = self.job(serve_opts, os.path.join(self.out_root, "warm"))
        for path, q in zip(paths, self.data["queries"]):
            np.savetxt(path, q, fmt="%i")
            if os.path.exists(path + ".npy"):
                os.remove(path + ".npy")
        shutil.rmtree(warm["out_dir"])
        return warm

    def job(self, serve_opts: dict, out_dir: str) -> dict:
        """One test-list job; returns the program's stats with the job's own
        wall-clock span."""
        from nestinet_tpu_torch.infer.device_pipeline import predict_shapes_device

        t0 = time.perf_counter()
        stats = predict_shapes_device(
            self.run_dir, testset=LIST + ".txt", data_path=self.data_dir,
            batch_size=self.traffic["batch_size"], output_dir=out_dir,
            seed=self.traffic["serve_seed"], sparse_patches=True, device=self.device,
            moe_inference=serve_opts["moe_inference"],
            compute_dtype=serve_opts["compute_dtype"], fold_bn=serve_opts["fold_bn"])
        t1 = time.perf_counter()
        return {"start": t0, "end": t1, "out_dir": out_dir, "stats": stats}


def run_window(setup: Setup, serve_opts: dict, seconds: float) -> dict:
    """Jobs back to back until one ends at or after `seconds`."""
    jobs = []
    t0 = time.perf_counter()
    while not jobs or jobs[-1]["end"] - t0 < seconds:
        jobs.append(setup.job(serve_opts, os.path.join(setup.out_root, f"job{len(jobs)}")))
    return {"t0": t0, "t1": jobs[-1]["end"], "jobs": jobs}


# ------------------------------------------------------------ the check


def read_answers(setup: Setup, jobs: list) -> tuple:
    """Every job's files: ({(job, shape): (normals, ids, probs)}, rows that
    are missing or not finite)."""
    moe = setup.cfg["model"] == "experts_n_est"
    answers, bad = {}, 0
    for j, job in enumerate(jobs):
        for s, name in enumerate(setup.data["names"]):
            want = setup.data["queries"][s].shape[0]
            base = os.path.join(job["out_dir"], name)
            try:
                n = np.loadtxt(base + ".normals", ndmin=2)
                ids = np.loadtxt(base + ".experts", dtype=np.int64, ndmin=1) if moe else None
                probs = np.loadtxt(base + ".experts_probs", ndmin=2) if moe else None
            except OSError:
                bad += want
                continue
            ok = n.shape == (want, 3) and np.isfinite(n).all()
            if moe:
                ok = ok and ids.shape == (want,) and probs.shape == (want, setup.cfg["n_experts"])
            if not ok:
                bad += want
                continue
            answers[(j, s)] = (n, ids, probs)
    return answers, bad


def draw_picks(setup: Setup, n_jobs: int, seed: int, n: int) -> list:
    """n (job, shape, query) triples drawn from the seed."""
    rng = np.random.RandomState(seed % (2 ** 32))
    sizes = [q.shape[0] for q in setup.data["queries"]]
    flat = rng.choice(n_jobs * sum(sizes), size=min(n, n_jobs * sum(sizes)), replace=False)
    out = []
    for f in flat.tolist():
        j, f = divmod(f, sum(sizes))
        s = 0
        while f >= sizes[s]:
            f -= sizes[s]
            s += 1
        out.append((j, s, f))
    return out


def reference_answers(setup: Setup, shape_queries: list, quant_bits=None) -> dict:
    """{(shape, query): (normals [E, 3], probs [E] or None)} from the
    reference, in blocks of CHECK_BLOCK patches."""
    cfg, dev = setup.cfg, setup.device
    W = {k: v.to(dev) for k, v in setup.W.items()}
    out = {}
    with torch.no_grad():
        for i in range(0, len(shape_queries), CHECK_BLOCK):
            block = shape_queries[i:i + CHECK_BLOCK]
            grid = reference_grid(cfg, setup.data, block, setup.traffic["serve_seed"],
                                  setup.traffic["batch_size"], dev)
            r = ref_model.serve_grid(cfg, W, grid, quant_bits)
            normals = r["normals"].transpose(0, 1).cpu().numpy().astype(np.float64)
            probs = None if r["probs"] is None else r["probs"].cpu().numpy().astype(np.float64)
            for b, key in enumerate(block):
                out[key] = (normals[b], None if probs is None else probs[b])
    del W
    return out


def _centred_logits(p: np.ndarray) -> np.ndarray:
    """The logits that softmax took to `p`, up to their mean (not finite
    where a probability is 0)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.log(p)
        return z - z.mean()


def compare(answers: dict, picks: list, ref: dict) -> dict:
    """The numbers over the picked answers (which of them a cell compares,
    its workload file's `limits` say; the others are printed as readings):
      normal_gap, normal_gap_p50: the largest and the median
        |n - n_ref| / max(|n_ref|, median |n_ref|), n_ref being the
        reference's normal from the expert the program chose;
      logit_gap, logit_gap_p50: the largest and the median over answers of
        max_e |z_e - z_ref_e|, z being the logits that the `.experts_probs`
        row's softmax took (up to their mean), over the median spread
        (standard deviation over experts) of the reference's logits;
      prob_gap: the largest |p - p_ref| over experts and answers;
      route_miss: the share of answers whose expert is not the reference's
        first maximum;
      id_mismatch: answers whose expert id is not the first maximum of the
        probabilities the same file row holds (exact)."""
    moe = next(iter(ref.values()))[1] is not None
    rows = []
    for j, s, q in picks:
        n, ids, probs = answers[(j, s)]
        rn, rp = ref[(s, q)]
        e = int(ids[q]) if moe else 0
        rows.append((n[q], rn[e], None if not moe else (e, probs[q], rp)))
    floor = float(np.median([np.linalg.norm(r[1]) for r in rows]))
    gaps = np.array([np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), floor)
                     for a, b, _ in rows])
    out = {"normal_gap": float(gaps.max()), "normal_gap_p50": float(np.median(gaps))}
    if moe:
        spread = float(np.median([_centred_logits(rp).std() for _, _, (e, p, rp) in rows]))
        with np.errstate(invalid="ignore"):
            logit = np.array([np.abs(_centred_logits(p) - _centred_logits(rp)).max()
                              for _, _, (e, p, rp) in rows]) / spread
        out["logit_gap"], out["logit_gap_p50"] = float(logit.max()), float(np.median(logit))
        out["prob_gap"] = max(float(np.abs(p - rp).max()) for _, _, (e, p, rp) in rows)
        out["route_miss"] = float(np.mean([e != int(np.argmax(rp)) for _, _, (e, p, rp) in rows]))
        out["id_mismatch"] = sum(int(e != int(np.argmax(p))) for _, _, (e, p, rp) in rows)
    return out


def control_answers(setup: Setup, picks: list, quant_bits: int) -> dict:
    """The reference at `quant_bits` put in the program's place: its
    answers in the files' form, for the picked (job 0, shape, query)."""
    keys = sorted({(s, q) for _, s, q in picks})
    got = reference_answers(setup, keys, quant_bits)
    answers = {}
    for s, q in keys:
        n_all, p = got[(s, q)]
        e = 0 if p is None else int(np.argmax(p))
        size = setup.data["queries"][s].shape[0]
        if (0, s) not in answers:
            answers[(0, s)] = (np.zeros((size, 3)),
                               None if p is None else np.zeros(size, np.int64),
                               None if p is None else np.zeros((size, p.shape[0])))
        n, ids, probs = answers[(0, s)]
        n[q] = n_all[e]
        if p is not None:
            ids[q], probs[q] = e, p
    return answers


def check(setup: Setup, window: dict, seed: int, control: dict | None) -> dict:
    """The run's answers against the reference: (numbers, attempted, failed)."""
    jobs = window["jobs"]
    answers, bad = read_answers(setup, jobs)
    n = setup.spec["cell"]["check_samples"]
    picks = [p for p in draw_picks(setup, len(jobs), seed ^ 0x5EED, n) if (p[0], p[1]) in answers]
    if control is not None:
        picks = [(0, s, q) for _, s, q in picks]
        answers = control_answers(setup, picks, control["quant_bits"])
    ref = reference_answers(setup, sorted({(s, q) for _, s, q in picks}))
    numbers = compare(answers, picks, ref) if picks else {}
    numbers["rows_bad"] = bad
    attempted = sum(q.shape[0] for q in setup.data["queries"]) * len(jobs)
    return {"numbers": numbers, "attempted": attempted, "failed": bad, "sampled": len(picks)}


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        tmp: str, control: dict | None = None) -> dict:
    """One run of a serving cell; returns what the result line needs."""
    from . import harness

    serve_opts = spec["cell"]["serve"]
    if control is not None and "serve" in control:  # the program's own lower path
        serve_opts, control = dict(serve_opts, **control["serve"]), None
    setup = Setup(spec, seed, tmp, device)
    warm = setup.warm_up(serve_opts)
    harness.log(f"set-up: warm-up job {warm['end'] - warm['start']:.3f} s, "
                f"{warm['stats']['n_patches']} patches")
    int8_calls = []
    with harness.window_memory(device) as mem, harness.maybe_trace(trace, device) as tr, \
            harness.record_int8_calls(trace, int8_calls):
        t_window = time.perf_counter()
        window = run_window(setup, serve_opts, seconds)
    setup_s = t_window - t_start
    jobs = window["jobs"]
    elapsed = window["t1"] - window["t0"]
    patches = sum(j["stats"]["n_patches"] for j in jobs)
    harness.log(f"window: {len(jobs)} jobs, {patches} patches in {elapsed:.3f} s")
    for j in jobs:
        st = j["stats"]
        harness.log(f"job: {j['end'] - j['start']:.3f} s, serving loop {st['seconds']:.3f} s, "
                    f"expert runs {st.get('expert_runs')}, forced flushes "
                    f"{st.get('forced_flushes')}, rows {st.get('expert_rows')}")
    spans = []
    for j in jobs:
        mid = j["end"] - j["stats"]["seconds"]
        spans += [("job_setup", j["start"], mid), ("serving", mid, j["end"])]
    result = {
        "end_to_end": {"serve_patches_per_s": patches / elapsed, "setup_s": setup_s},
        "memory_peak_bytes": mem.peak,
        "window": window, "spans": spans, "trace": tr, "int8_calls": int8_calls,
        "serve_opts": serve_opts,
    }
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    result["check"] = check(setup, window, seed, control)
    harness.log(f"check: {result['check']['sampled']} answers against the reference in "
                f"{time.perf_counter() - t_check:.3f} s")
    return result


def layer_context(spec: dict, result: dict) -> dict:
    """What the per-layer readers of a serving cell read."""
    jobs = result["window"]["jobs"]
    return {"kind": "serve", "spec": spec, "jobs": [j["stats"] | {"wall": j["end"] - j["start"]}
                                                   for j in jobs],
            "t0": result["window"]["t0"], "t1": result["window"]["t1"],
            "spans": result["spans"], "trace": result["trace"],
            "int8_calls": result["int8_calls"], "serve_opts": result["serve_opts"]}


