"""The port's test_all, evaluate (with expert statistics) and synth CLIs
against the JAX package's, on the CPU.

  * `cli.test_all` of both packages over two test lists of one tiny
    `experts_n_est` run dir that only the JAX package wrote (the manager's
    logits spread): `.normals` within atol 1e-4, `.experts` identical;
  * `cli.evaluate --expert_statistics 1` of both packages on JAX's results:
    the summary files and the expert-statistics JSON identical;
    `compute_expert_statistics` on dense and sparse predictions, with and
    without the `.pidx` subset, equal to JAX's;
  * `cli.synth` of both packages, the protocol and the switching sets,
    byte for byte;
  * the visualization export and the expert-statistics plots raise
    NotImplementedError (matplotlib and `viz/` are not ported).
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nestinet_tpu.cli import evaluate as jax_cli_evaluate
from nestinet_tpu.cli import synth as jax_cli_synth
from nestinet_tpu.cli import test_all as jax_cli_test_all
from nestinet_tpu.eval.expert_stats import compute_expert_statistics as jax_expert_stats
from nestinet_tpu_torch.cli import evaluate as cli_evaluate
from nestinet_tpu_torch.cli import synth as cli_synth
from nestinet_tpu_torch.cli import test_all as cli_test_all
from nestinet_tpu_torch.eval.evaluate import evaluate_datasets
from nestinet_tpu_torch.eval.expert_stats import compute_expert_statistics

from .test_torch_slice import build_data, build_run
from tests._torch_disk import remove_module_tmp, remove_tmp_path  # noqa: F401

torch.set_num_threads(1)

LISTS = ("scene_a", "scene_b")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both test_all CLIs over two test lists (one shape and two shapes)
    of the synthetic testset, on one JAX-only run dir."""
    root = str(tmp_path_factory.mktemp("torch_cli_tools"))
    data = build_data(root)
    run = build_run(root, data)
    shutil.rmtree(os.path.join(run, "ckpt_torch"))
    with open(os.path.join(data, "testset.txt")) as f:
        shapes = [s.strip() for s in f if s.strip()]
    lists = {"scene_a": shapes[:1], "scene_b": shapes[1:3]}
    for name, members in lists.items():
        with open(os.path.join(data, name + ".txt"), "w") as f:
            f.write("\n".join(members) + "\n")
    with open(os.path.join(data, "scenes.txt"), "w") as f:
        f.write("scene_a.txt\nscene_b.txt\n")
    args = ["--results_path", run, "--dataset_path", data, "--testset_list", "scenes.txt",
            "--batch_size", "64", "--loader_workers", "2"]
    jax_cli_test_all.main(args + ["--dataset_name", "jax"])
    cli_test_all.main(args + ["--dataset_name", "port", "--device", "cpu"])
    return data, run, lists


def test_test_all_equals_jax(served):
    data, run, lists = served
    ids = []
    for shape in lists["scene_a"] + lists["scene_b"]:
        n = np.loadtxt(os.path.join(data, shape + ".xyz")).shape[0]
        load = lambda who, ext: np.loadtxt(  # noqa: E731
            os.path.join(run, f"{who}_results", shape + ext))
        got, want = load("port", ".normals"), load("jax", ".normals")
        assert got.shape == want.shape == (n, 3)  # dense: every point
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        ids.append(load("port", ".experts"))
        np.testing.assert_array_equal(ids[-1], load("jax", ".experts"))
    assert len(np.unique(np.concatenate(ids))) > 1


def _evaluate(main, results, data, extra=()):
    main(["--normal_results_path", results, "--data_path", data, "--dataset_list",
          *LISTS, "--expert_statistics", "1", "--n_experts", "7", *extra])


def test_cli_evaluate_equals_jax(served, tmp_path):
    data, run, _ = served
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path / who)
        shutil.copytree(os.path.join(run, "jax_results"), dirs[who])
    _evaluate(jax_cli_evaluate.main, dirs["jax"], data)
    _evaluate(cli_evaluate.main, dirs["port"], data)
    for name in LISTS:
        summary = os.path.join("summary", f"{name}_evaluation_results.txt")
        assert filecmp.cmp(os.path.join(dirs["port"], summary),
                           os.path.join(dirs["jax"], summary), shallow=False)
        stats = os.path.join("images", "expert_statistics", f"{name}_expert_statistics.json")
        with open(os.path.join(dirs["port"], stats)) as f:
            got = json.load(f)
        with open(os.path.join(dirs["jax"], stats)) as f:
            want = json.load(f)
        assert got == want
        assert sum(got["count"]) == 100 * len(got["per_shape"])  # the .pidx points


@pytest.mark.parametrize("use_subset", [True, False])
@pytest.mark.parametrize("sparse", [False, True])
def test_expert_statistics_equal_jax(served, tmp_path, use_subset, sparse):
    data, run, lists = served
    results = str(tmp_path / "results")
    shutil.copytree(os.path.join(run, "jax_results"), results)
    if sparse:  # predictions only at the .pidx points, as sparse serving writes them
        for shape in lists["scene_b"]:
            pidx = np.loadtxt(os.path.join(data, shape + ".pidx")).astype(int)
            for ext in (".normals", ".experts"):
                path = os.path.join(results, shape + ext)
                np.savetxt(path, np.loadtxt(path)[pidx])
    kw = dict(n_experts=7, use_subset=use_subset, log=lambda *_: None)
    got = compute_expert_statistics(data, results, "scene_b", **kw)
    want = jax_expert_stats(data, results, "scene_b", export_plots=False, **kw)
    assert json.dumps(got) == json.dumps(want)
    served_points = sum(np.loadtxt(os.path.join(results, s + ".experts")).size
                        for s in lists["scene_b"])
    if sparse or not use_subset:
        assert sum(got["count"]) == served_points


@pytest.mark.parametrize("switching", [False, True])
def test_cli_synth_equals_jax(tmp_path, capsys, switching):
    args = ["--n_points", "120", "--n_pidx", "20", "--seed", "4"]
    args += ["--switching"] if switching else []
    jax_cli_synth.main(["--root", str(tmp_path / "jax")] + args)
    want_out = capsys.readouterr().out
    cli_synth.main(["--root", str(tmp_path / "port")] + args)
    assert capsys.readouterr().out == want_out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) > 20
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax", tmp_path / "port", names,
                                           shallow=False)
    assert not mismatch and not errors


def test_unported_plots_raise(served, tmp_path):
    data, run, _ = served
    results = os.path.join(run, "jax_results")
    with pytest.raises(NotImplementedError, match="item 4"):
        evaluate_datasets(data, results, list(LISTS), export=True)
    with pytest.raises(NotImplementedError, match="item 4"):
        _evaluate(cli_evaluate.main, results, data, ["--export_visualizations", "1"])
    with pytest.raises(NotImplementedError, match="item 4"):
        compute_expert_statistics(data, results, "scene_a", export_plots=True)
