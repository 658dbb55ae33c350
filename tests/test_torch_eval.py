"""The port's evaluation entry point and reports (modular_slam_tpu_torch.eval
.evaluate, .report) against the JAX package's, on the CPU: the TUM
loader and the --compare resolution, the CSV and the rendered overlays,
and a whole evaluation of two 8-frame 320x240 datasets (the odometry
preset, with a --compare trajectory), whose report.json, ate.csv and
trajectories must agree with the JAX package's; the port's own --multiseq
block; and the card required without --cpu.

As in tests/test_torch_cli.py, the two packages draw RANSAC hypotheses
from different streams, and their trajectories must agree within
POSE_TOL_M (they agree to 1e-6 m, the precision of the trajectory file,
on these frames)."""

import json
import math
import os

import numpy as np
import pytest
import torch

from modular_slam_tpu.eval import evaluate as jev
from modular_slam_tpu.eval import report as jrep
from modular_slam_tpu_torch.eval import evaluate as tev
from modular_slam_tpu_torch.eval import report as trep
from modular_slam_tpu_torch.eval.ate import ate_rmse
from modular_slam_tpu_torch.eval.make_dataset import write_dataset

POSE_TOL_M = 1e-3
ATE_TOL_M = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread (see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_load_tum_trajectory(tmp_path):
    p = tmp_path / "traj.txt"
    p.write_text("# header\n"
                 "0.0 1 2 3 0 0 0 1\n"
                 "\n"
                 "0.1 1.1 2 3 0 0 0 1 extra_col\n")
    t = tev._load_tum_trajectory(str(p))
    np.testing.assert_array_equal(t, jev._load_tum_trajectory(str(p)))
    assert t.shape == (2, 8)
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    with pytest.raises(ValueError, match="no trajectory rows"):
        tev._load_tum_trajectory(str(empty))


def test_comparison_trajectory_resolution(tmp_path):
    d = tmp_path / "runs"
    d.mkdir()
    (d / "seq1.txt").write_text("0 0 0 0 0 0 0 1\n")
    f = tmp_path / "one.txt"
    f.write_text("0 0 0 0 0 0 0 1\n")
    for spec, name, n in ((d, "seq1", 2), (d, "seq2", 2), (f, "any", 1),
                          (f, "any", 2)):
        assert tev._comparison_trajectory(str(spec), name, n) == \
            jev._comparison_trajectory(str(spec), name, n)
    assert tev._comparison_trajectory(str(d), "seq1", 2) is not None
    assert tev._comparison_trajectory(str(f), "any", 2) is None


def test_report_outputs_match_jax(tmp_path):
    """tests/test_utils.py::test_eval_report_outputs on the port, with
    the CSV and the two renderings equal to the JAX package's."""
    est = np.zeros((20, 8))
    est[:, 0] = np.arange(20) / 30.0
    est[:, 1] = np.linspace(0, 1, 20)
    est[:, 7] = 1.0
    gt = est.copy()
    gt[:, 1] += 0.01

    paths = trep.plot_trajectories(est, gt, str(tmp_path), name="t")
    assert os.path.exists(paths["xyz"]) and os.path.exists(paths["topdown"])

    stats = {"seq": ate_rmse(est, gt), "seq:keyframes": ate_rmse(est, est)}
    trep.write_ate_csv(str(tmp_path / "t.csv"), stats)
    jrep.write_ate_csv(str(tmp_path / "j.csv"), stats)
    rows = (tmp_path / "t.csv").read_text()
    assert rows == (tmp_path / "j.csv").read_text()
    assert rows.splitlines()[0].startswith("sequence,rmse")
    assert len(rows.strip().splitlines()) == 3

    rgb = np.random.default_rng(1).integers(0, 255, (40, 60, 3)).astype(
        np.uint8)
    kp = np.array([[10.0, 10.0], [30.0, 20.0]])
    out = trep.render_observation_overlay(rgb, kp, kp + 3.0,
                                          path=str(tmp_path / "ovl.png"))
    assert os.path.exists(tmp_path / "ovl.png")
    np.testing.assert_array_equal(
        out, jrep.render_observation_overlay(rgb, kp, kp + 3.0))
    d = np.random.default_rng(0).uniform(0, 5, (40, 60)).astype(np.float32)
    cm = trep.render_depth_colormap(d, path=str(tmp_path / "d.png"))
    assert cm.shape == (40, 60, 3)
    np.testing.assert_array_equal(cm, jrep.render_depth_colormap(d))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    dirs = []
    for s in range(2):
        d = str(root / f"seq{s}")
        write_dataset(d, frames=8, loop=False, width=320, height=240,
                      seed=s)
        dirs.append(d)
    # an "external" trajectory per sequence: its ground truth
    ext = root / "perfect"
    ext.mkdir()
    for d in dirs:
        gt = np.loadtxt(os.path.join(d, "groundtruth.txt"))
        np.savetxt(ext / (os.path.basename(d) + ".txt"), gt[:, :8])
    return dirs, {"perfect": str(ext)}


def test_evaluate_matches_jax(datasets, tmp_path):
    dirs, compare = datasets
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jrep_ = jev.evaluate_datasets(dirs, str(jout), pipeline="odometry",
                                  compare=compare)
    trep_ = tev.evaluate_datasets(dirs, str(tout), pipeline="odometry",
                                  compare=compare, device="cpu")
    assert json.loads((tout / "report.json").read_text()) == trep_
    assert trep_["pipeline"] == jrep_["pipeline"] == "odometry"
    assert trep_["sequences"].keys() == jrep_["sequences"].keys()
    for name, j in jrep_["sequences"].items():
        t = trep_["sequences"][name]
        assert t.keys() == j.keys(), name
        for k in ("frames", "keyframes", "landmarks", "loop_closures"):
            assert t[k] == j[k], (name, k)
        assert t["frames"] == 8
        assert abs(t["ate_rmse"] - j["ate_rmse"]) <= ATE_TOL_M
        assert t["compare"]["perfect"] < 1e-6
        assert t.get("plot_error") == j.get("plot_error")
        tt = np.loadtxt(tout / name / "trajectory.txt")
        jt = np.loadtxt(jout / name / "trajectory.txt")
        assert tt.shape == jt.shape == (8, 8)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=POSE_TOL_M)
    tcsv = (tout / "ate.csv").read_text().splitlines()
    jcsv = (jout / "ate.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in tcsv] == [r.split(",")[0] for r in jcsv]
    assert len(tcsv) == 1 + 2 * 2       # per sequence: own, perfect


def test_main_multiseq_needs_the_card_unless_cpu(datasets, tmp_path,
                                                 capsys):
    """`--multiseq --cpu` from the command line: the report's batched
    block (one device on the CPU); without --cpu the card is required."""
    dirs, _ = datasets
    out = tmp_path / "r"
    assert tev.main(["--datasets", *dirs, "--out", str(out), "--pipeline",
                     "odometry", "--max-frames", "2", "--multiseq",
                     "--cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads((out / "report.json").read_text()) == report
    assert [s["frames"] for s in report["sequences"].values()] == [2, 2]
    ms = report["multiseq"]
    assert (ms["batch"], ms["devices"]) == (2, 1)
    assert math.isfinite(ms["scaling_efficiency"])
    assert ms["single_seq_fps"] > 0 and ms["batched_fps"] > 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.main(["--datasets", dirs[0], "--out", str(tmp_path / "c"),
                  "--max-frames", "1"])
