"""The port's `infer/predict.py::SparseMoeRouter` against JAX's, on the CPU.

JAX's router (`nestinet_tpu/infer/predict.py:423-778`) decides which rows
share an expert run: it parks each batch's grid in a FIFO of W slots,
processes the manager's probabilities `depth` batches late, appends each
batch's winners to per-expert buckets, runs an expert when its bucket holds
B rows, flushes a slot's rows before the slot is overwritten and the rest
at the end, and pads a partial run with the FIFO's first row.  Under int8
every conv and linear quantizes its whole input at one scale, so a patch's
normal depends on those runs.

  * `test_runs_equal_jax`: both routers driven with stub models on the same
    probabilities (each parked grid row encodes its global row id, as
    `tests/test_sparse_router.py` does); every expert run, its expert and
    the ids of its rows, pads included, in order, must be identical, and
    so must the forced flushes and the window;
  * `test_patch_row_association`: the port's emitted normal of each patch
    comes from its own parked row and its own expert, across evictions;
  * `test_int8_per_patch_equals_jax`: a tiny-backbone run dir served routed
    in int8 by both packages' host `predict_shapes` at B = 16 and W = 4,
    where runs cross batches and slots are evicted: ids identical and
    every patch's normal within `INT8_ATOL` of JAX's.  JAX runs with
    `jax.disable_jit()`: its jitted programs keep float32 inside fused
    bfloat16 chains, which moved 2 of 600 manager ids on this run dir's six
    shapes, while the port
    rounds as eager JAX does (`tests/test_torch_dtypes.py`).  Measured: the
    normals equal to the last bit; before the port took JAX's schedule
    (each expert run on one batch's rows) 156 of the 200 patches missed
    `INT8_ATOL`, by up to 0.061.
"""

import os
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from nestinet_tpu.infer.predict import SparseMoeRouter as JaxRouter  # noqa: E402
from nestinet_tpu_torch.infer.predict import SparseMoeRouter  # noqa: E402
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: E402,F401

torch.set_num_threads(1)

ROW = 20  # a stub grid row: resolution 1, one scale
INT8_ATOL = 1e-5


class _Group:
    def __init__(self, n_experts):
        self.starts = [0] * n_experts
        self.channels = ROW
        self.indices = list(range(n_experts))
        self.n_scales = 1


def _jax_stub(n_experts: int, runs: list):
    """JAX's model as its router sees it: one group, member = expert; its
    program B records (expert, the gathered rows' encoded ids)."""
    m = types.SimpleNamespace(resolution=1, compute_dtype=jnp.float32,
                              cfg=types.SimpleNamespace(n_scales=1), n_experts=n_experts,
                              groups=[_Group(n_experts)])
    m.expert_to_group = lambda: {e: (0, e) for e in range(n_experts)}

    def expert_on_buf(params, state, buf, flat_idx, member):
        rows = buf.reshape(-1, buf.shape[-1])[flat_idx]
        runs.append((int(member), np.asarray(rows[:, 0]).astype(np.int64).tolist()))
        return rows[:, :3] + jnp.float32(member) * 1000.0

    m._serving_jits = {"expert_on_buf_0": expert_on_buf}
    return m


class _PortStub:
    """The port's model as its router sees it."""

    resolution = 1
    compute_dtype = torch.float32
    cfg = types.SimpleNamespace(n_scales=1)

    def __init__(self, n_experts: int, runs: list):
        self.n_experts = n_experts
        self.runs = runs

    def expert_on_grid(self, e, rows):
        flat = rows.reshape(rows.shape[0], -1)
        self.runs.append((e, flat[:, 0].to(torch.int64).tolist()))
        return flat[:, :3] + 1000.0 * e


def _batches(n_patches, batch_size, n_experts, kind, seed):
    """[(real, grid [B, ROW] with each row's global row id, probabilities
    [E, B])] of the stream."""
    rng = np.random.RandomState(seed)
    out = []
    for start in range(0, n_patches, batch_size):
        real = min(batch_size, n_patches - start)
        grid = np.zeros((batch_size, ROW), np.float32)
        grid[:, :3] = (start + np.arange(batch_size))[:, None]
        probs = rng.dirichlet(np.ones(n_experts), batch_size).T.astype(np.float32)
        if kind == "never_wins":
            probs[2] = 0.0
        elif kind == "wins_all":
            probs[1] = 2.0
        elif kind == "ties":
            probs[:, ::5] = 0.25  # argmax: the first maximum
        out.append((real, grid, probs))
    return out


def _run_jax(batches, n_experts, batch_size, window):
    runs, emitted = [], []
    writer = types.SimpleNamespace(done=True, written=[],
                                   append=lambda n, e, p: emitted.append((n, e, p)))
    router = JaxRouter(_jax_stub(n_experts, runs), params=None, state=None,
                       cfg=types.SimpleNamespace(n_scales=1, n_experts=n_experts),
                       writer=writer, batch_size=batch_size, window_slots=window)
    for real, grid, probs in batches:
        slot = router.begin_batch()
        buf = router.buf.at[int(slot)].set(jnp.asarray(grid))
        router.commit(real, jnp.asarray(probs), buf)
    stats = router.finish(0.0, "")
    return runs, stats, emitted


def _run_port(batches, n_experts, batch_size, window):
    runs, emitted = [], []
    router = SparseMoeRouter(_PortStub(n_experts, runs), batch_size,
                             lambda *out: emitted.append(out), device=torch.device("cpu"),
                             window_slots=window)
    for real, grid, probs in batches:
        router.begin_batch()
        router.commit(real, torch.from_numpy(probs),
                      torch.from_numpy(grid).reshape(batch_size, 1, 1, 1, ROW))
    return runs, router.finish(), emitted


# (patches, B, W, depth, experts, probabilities)
CASES = {
    "w2_evictions": (97, 4, 2, 3, 3, "random"),
    "w3_evictions": (97, 4, 3, 3, 4, "random"),
    "default_window": (300, 8, None, 3, 4, "random"),
    "partial_last_batch": (101, 8, 5, 3, 4, "random"),
    "an_expert_never_wins": (150, 8, 6, 3, 4, "never_wins"),
    "one_expert_wins_all": (150, 8, 6, 3, 4, "wins_all"),
    "ties_depth1": (150, 8, 6, 1, 4, "ties"),
    "depth3_b64": (900, 64, 4, 3, 7, "random"),
    "depth1_b64": (900, 64, 5, 1, 7, "random"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runs_equal_jax(case, monkeypatch):
    n_patches, batch_size, window, depth, n_experts, kind = CASES[case]
    monkeypatch.setenv("NESTINET_MANAGER_DEPTH", str(depth))
    batches = _batches(n_patches, batch_size, n_experts, kind, seed=len(case))
    want, want_stats, _ = _run_jax(batches, n_experts, batch_size, window)
    got, got_stats, _ = _run_port(batches, n_experts, batch_size, window)
    assert len(got) == len(want) and got == want
    assert got_stats["expert_runs"] == len(want)
    for key in ("forced_flushes", "window_slots"):
        assert got_stats[key] == want_stats[key], key
    if kind == "never_wins":
        assert 2 not in {e for e, _ in got}
    if kind == "wins_all":
        assert {e for e, _ in got} == {1} and want_stats["forced_flushes"] <= 1


@pytest.mark.parametrize("n_patches,batch_size,window", [(97, 4, 3), (64, 8, 2), (500, 32, 4)])
def test_patch_row_association(n_patches, batch_size, window):
    """Every patch's normal is its own parked row's id plus 1000 x its own
    expert, its id and probabilities its own, in patch order, as JAX's
    `tests/test_sparse_router.py` holds JAX's router."""
    batches = _batches(n_patches, batch_size, 3, "random", seed=n_patches)
    _, stats, emitted = _run_port(batches, 3, batch_size, window)
    normals, ids, probs = (np.concatenate([e[i] for e in emitted]) for i in range(3))
    want_probs = np.concatenate([p[:, :real].T for real, _, p in batches])
    route = want_probs.argmax(axis=1)
    assert stats["window_slots"] == max(2, window) and stats["forced_flushes"] > 0
    np.testing.assert_array_equal(ids, route)
    np.testing.assert_array_equal(probs, want_probs)
    want = np.arange(n_patches)[:, None] + 1000.0 * route[:, None]
    np.testing.assert_array_equal(normals, np.broadcast_to(want, (n_patches, 3)))


def test_int8_per_patch_equals_jax(tmp_path_factory):
    from nestinet_tpu.infer.predict import predict_shapes as jax_predict_shapes
    from nestinet_tpu_torch.infer.predict import predict_shapes

    from .test_torch_slice import build_data, build_run

    root = str(tmp_path_factory.mktemp("torch_router_int8"))
    data = build_data(root)
    run = build_run(root, data)
    with open(os.path.join(data, "testset.txt")) as f:
        shapes = f.read().split()[:2]
    with open(os.path.join(data, "testset_two.txt"), "w") as f:
        f.write("\n".join(shapes) + "\n")
    kw = dict(testset="testset_two.txt", data_path=data, batch_size=16, loader_workers=2,
              moe_inference="sparse", compute_dtype="int8", sparse_patches=True,
              sparse_window_slots=4)
    with jax.disable_jit():
        want = jax_predict_shapes(run, output_dir=os.path.join(root, "jax"), **kw)
    got = predict_shapes(run, output_dir=os.path.join(root, "port"), device="cpu", **kw)
    assert got["n_patches"] == want["n_patches"] == 200
    assert got["forced_flushes"] == want["forced_flushes"] and got["window_slots"] == 4
    assert 0 < got["forced_flushes"] < got["expert_runs"]  # full runs and flushes
    worst, off = 0.0, 0
    for shape in shapes:
        load = lambda d, ext: np.loadtxt(os.path.join(d, shape + ext))  # noqa: E731
        np.testing.assert_array_equal(load(got["output_dir"], ".experts"),
                                      load(want["output_dir"], ".experts"))
        gap = np.abs(load(got["output_dir"], ".normals")
                     - load(want["output_dir"], ".normals")).max(axis=1)
        worst, off = max(worst, gap.max()), off + int((gap > INT8_ATOL).sum())
    print(f"int8 routed against eager JAX: {got['expert_runs']} runs, "
          f"{got['forced_flushes']} forced flushes; normals max abs gap {worst:.3e}, "
          f"{off} patches over {INT8_ATOL}")
    assert off == 0
