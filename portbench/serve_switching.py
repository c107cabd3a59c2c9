"""How the noise-switching model's cells (`ms_sw_n_est`) are served: the
same test-list jobs, window and warm-up as `serve.py`, with the model's
own set-up, answers and comparison.

Set-up draws the three CNNs' weights from the seed and calibrates them on
the reference (`weights_switching.py`: about half the calibration patches
take each branch), writes the run dir, then serves the warm-up job.  The
window runs jobs back to back from one client, as `serve.py` does.  Each
job is served routed: the noise CNN on every batch, each patch through
the branch of `noise < 0.015` only; it writes `.normals`, `.experts` (the
branch: 0 the small radius, 1 the large) and `.noise` (the estimate).

After the window, a sample of the answers drawn from the seed (job, shape,
query) is read back from the files and held to the plain reference
(`reference/switching.py`), which extracts the same patches and computes
their statistics, the noise estimate and both branches' normals in
float32 with TF32 off.  A program that cannot serve the switching model
routed fails at once, before any set-up.

The interface `harness.py` finds by the name in the cell's workload file:
`run(spec, seed, seconds, trace, device, t_start, tmp, control)` and
`layer_context(spec, result)`.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from . import serve
from . import weights_switching as wsw
from .counts.switching import served_gflop
from .reference import switching as ref_sw
from .serve import (CHECK_BLOCK, LIST, Setup, calibration_picks, draw_picks, reference_grid,
                    run_window, write_run_dir)
from .traffic import generate


def program_routes_switching() -> bool:
    """True when the program serves the switching model through its router
    (the model's `gate`, `route` and `expert_on_grid`)."""
    from nestinet_tpu_torch.models.switching import SwitchingNormEst

    return all(hasattr(SwitchingNormEst, n) for n in ("gate", "route", "expert_on_grid"))


@contextlib.contextmanager
def program_backbone(cfg: dict, device):
    """The program's switching CNNs built with the configuration's layer
    table.  The program takes it from `models/backbones.py::SW_BACKBONE`,
    which a run dir does not record; at the configuration's published
    widths the two are one table and nothing changes.  On a card a
    configuration whose table is not the program's raises, so that no cell
    measures other widths than the program's; on the CPU the rehearsals at
    toy sizes (`tests/toy.py`) narrow the program's table to theirs."""
    from nestinet_tpu_torch.models import backbones

    table = [(e[0], e[1], tuple(e[2])) if e[0] == "incep" else tuple(e)
             for e in cfg["net"]["backbone"]]
    if table == [tuple(e) for e in backbones.SW_BACKBONE]:
        yield
        return
    if device.type != "cpu":
        raise ValueError(f"the configuration's backbone {table} is not the program's "
                         f"SW_BACKBONE {backbones.SW_BACKBONE}")
    saved = backbones.SW_BACKBONE
    backbones.SW_BACKBONE = table
    try:
        yield
    finally:
        backbones.SW_BACKBONE = saved


class SwitchingSetup(Setup):
    """Inputs, weights and run dir of one run, under `tmp`; `job` and
    `warm_up` are `serve.Setup`'s."""

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
        W = wsw.make(cfg, seed, device)
        grid = reference_grid(cfg, self.data, calibration_picks(self.data, CHECK_BLOCK),
                              traffic["serve_seed"], traffic["batch_size"], device)
        t2 = time.perf_counter()
        spread = wsw.calibrate(cfg, W, grid)
        del grid
        if device.type == "cuda":
            torch.cuda.synchronize()
        t3 = time.perf_counter()
        log(f"set-up: noise estimates' std before the rescale {spread['z_std']}, scale "
            f"{spread['scale']}; the small branch takes {spread['small_share']} of the "
            f"{CHECK_BLOCK} calibration patches")
        write_run_dir(cfg, W, self.run_dir)
        log(f"set-up: shapes written in {t1 - t0:.3f} s; the reference's extraction of "
            f"{CHECK_BLOCK} calibration patches with the weights drawn {t2 - t1:.3f} s; "
            f"the reference's calibrating forward {t3 - t2:.3f} s; run dir written "
            f"{time.perf_counter() - t3:.3f} s")
        self.W = {k: v.cpu() for k, v in W.items()}
        del W


# ------------------------------------------------------------ the check


def below(noise, threshold: float):
    """The switch's test, in float32 as the model compares."""
    return np.asarray(noise, np.float32) < np.float32(threshold)


def read_answers(setup: Setup, jobs: list) -> tuple:
    """Every job's files: ({(job, shape): (normals, branches, noise)}, rows
    that are missing, not finite or of no branch)."""
    answers, bad = {}, 0
    for j, job in enumerate(jobs):
        for s, name in enumerate(setup.data["names"]):
            want = setup.data["queries"][s].shape[0]
            base = os.path.join(job["out_dir"], name)
            try:
                n = np.loadtxt(base + ".normals", ndmin=2)
                ids = np.loadtxt(base + ".experts", dtype=np.int64, ndmin=1)
                noise = np.loadtxt(base + ".noise", ndmin=1)
            except (OSError, ValueError):
                bad += want
                continue
            ok = (n.shape == (want, 3) and ids.shape == (want,) and noise.shape == (want,)
                  and np.isfinite(n).all() and np.isfinite(noise).all()
                  and np.isin(ids, (0, 1)).all())
            if not ok:
                bad += want
                continue
            answers[(j, s)] = (n, ids, noise)
    return answers, bad


def reference_answers(setup: Setup, shape_queries: list, quant_bits=None) -> dict:
    """{(shape, query): (both branches' normals [2, 3], noise)} from the
    reference, in blocks of CHECK_BLOCK patches."""
    cfg, dev = setup.cfg, setup.device
    W = {k: v.to(dev) for k, v in setup.W.items()}
    out = {}
    with torch.no_grad():
        for i in range(0, len(shape_queries), CHECK_BLOCK):
            block = shape_queries[i:i + CHECK_BLOCK]
            grid = reference_grid(cfg, setup.data, block, setup.traffic["serve_seed"],
                                  setup.traffic["batch_size"], dev)
            r = ref_sw.serve_grid(cfg, W, grid, quant_bits)
            normals = r["normals"].transpose(0, 1).cpu().numpy().astype(np.float64)
            noise = r["noise"].cpu().numpy()
            for b, key in enumerate(block):
                out[key] = (normals[b], noise[b])
    del W
    return out


def compare(answers: dict, picks: list, ref: dict, threshold: float) -> dict:
    """The numbers over the picked answers (which of them a cell compares,
    its workload file's `limits` say):
      normal_gap, normal_gap_p50: the largest and the median
        |n - n_ref| / max(|n_ref|, median |n_ref|), n_ref being the
        reference's normal from the branch the program chose;
      branch_miss: the share of answers whose branch is not the reference's
        (noise_ref < threshold);
      noise_gap_p50: the median |noise - noise_ref| over the median
        |noise_ref - threshold|;
      noise_gap: the largest |noise - noise_ref| over the same median."""
    rows = []
    for j, s, q in picks:
        n, ids, noise = answers[(j, s)]
        rn, rnoise = ref[(s, q)]
        e = int(ids[q])
        rows.append((n[q], rn[e], e, float(noise[q]), float(rnoise)))
    floor = float(np.median([np.linalg.norm(r[1]) for r in rows]))
    gaps = np.array([np.linalg.norm(a - b) / max(float(np.linalg.norm(b)), floor)
                     for a, b, _, _, _ in rows])
    noise, rnoise = (np.array([r[k] for r in rows]) for k in (3, 4))
    spread = float(np.median(np.abs(rnoise - threshold)))
    ngap = np.abs(noise - rnoise) / spread
    chosen = np.array([r[2] for r in rows])
    return {"normal_gap": float(gaps.max()), "normal_gap_p50": float(np.median(gaps)),
            "branch_miss": float(np.mean(chosen != np.where(below(rnoise, threshold), 0, 1))),
            "noise_gap_p50": float(np.median(ngap)), "noise_gap": float(ngap.max())}


def switch_mismatch(answers: dict, threshold: float) -> int:
    """Rows, over every answer read, whose branch is not their own noise's:
    0 where noise < threshold, else 1 (exact)."""
    return sum(int((ids != np.where(below(noise, threshold), 0, 1)).sum())
               for _, ids, noise in answers.values())


def control_answers(setup: Setup, picks: list, quant_bits: int) -> dict:
    """The reference at `quant_bits` put in the program's place: its
    answers in the files' form, for the picked (job 0, shape, query)."""
    threshold = setup.cfg["noise_threshold"]
    keys = sorted({(s, q) for _, s, q in picks})
    got = reference_answers(setup, keys, quant_bits)
    answers = {}
    for s, q in keys:
        normals, noise = got[(s, q)]
        size = setup.data["queries"][s].shape[0]
        if (0, s) not in answers:
            answers[(0, s)] = (np.zeros((size, 3)), np.ones(size, np.int64), np.ones(size))
        n, ids, nz = answers[(0, s)]
        ids[q] = 0 if below(noise, threshold) else 1
        n[q], nz[q] = normals[ids[q]], noise
    return answers


def check(setup: Setup, window: dict, seed: int, control: dict | None) -> dict:
    """The run's answers against the reference: (numbers, attempted, failed)."""
    threshold = setup.cfg["noise_threshold"]
    jobs = window["jobs"]
    answers, bad = read_answers(setup, jobs)
    n = setup.spec["cell"]["check_samples"]
    picks = [p for p in draw_picks(setup, len(jobs), seed ^ 0x5EED, n) if (p[0], p[1]) in answers]
    if control is not None:
        picks = [(0, s, q) for _, s, q in picks]
        answers = control_answers(setup, picks, control["quant_bits"])
    ref = reference_answers(setup, sorted({(s, q) for _, s, q in picks}))
    numbers = compare(answers, picks, ref, threshold) if picks else {}
    numbers["switch_mismatch"] = switch_mismatch(answers, threshold)
    numbers["rows_bad"] = bad
    attempted = sum(q.shape[0] for q in setup.data["queries"]) * len(jobs)
    return {"numbers": numbers, "attempted": attempted, "failed": bad, "sampled": len(picks)}


def run(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        tmp: str, control: dict | None = None) -> dict:
    """One run of a switching serving cell; returns what the result line
    needs."""
    from . import harness

    if not program_routes_switching():
        raise RuntimeError("the program does not serve the switching model routed (no "
                           "SwitchingNormEst.gate, .route and .expert_on_grid)")
    serve_opts = spec["cell"]["serve"]
    if control is not None and "serve" in control:  # the program's own lower path
        serve_opts, control = dict(serve_opts, **control["serve"]), None
    with program_backbone(spec["config"], device):
        setup = SwitchingSetup(spec, seed, tmp, device)
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
                    f"branch runs {st.get('expert_runs')}, forced flushes "
                    f"{st.get('forced_flushes')}, branch rows {st.get('branch_rows')}")
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
    """What the per-layer readers of a serving cell read, and the window's
    served GFLOP (`served_gflop`: the noise CNN on every patch and each
    patch's branch, from the configuration's layer table; absent where a
    job counted no branches)."""
    ctx = serve.layer_context(spec, result)
    jobs = [j["stats"] for j in result["window"]["jobs"]]
    if all("branch_rows" in j for j in jobs):
        ctx["served_gflop"] = sum(served_gflop(spec["config"], j["n_patches"], j["branch_rows"])
                                  for j in jobs)
    return ctx
