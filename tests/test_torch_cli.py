"""The port's command-line runner (`modular_slam_tpu_torch.run`) against
the JAX package's (`modular_slam_tpu.run`, as tests/test_cli.py drives
it) on a 10-frame 320x240 dataset, on the CPU.

Both runs take the default flags (the `slam` preset, chunks of 16 in the
wire format, deferred) and draw RANSAC hypotheses from different streams
(the JAX key against the port's seeded sampler): the same frames and
tracked frames, and trajectories within POSE_TOL_M (they agree to 1e-6 m,
the precision of the trajectory file)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from modular_slam_tpu.config import SlamConfig as JaxSlamConfig
from modular_slam_tpu.run import apply_overrides as jax_apply_overrides
from modular_slam_tpu.run import main as jax_main
from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.eval.make_dataset import write_dataset
from modular_slam_tpu_torch.run import apply_overrides
from modular_slam_tpu_torch.run import main as port_main

POSE_TOL_M = 1e-3
# --chunk 1 against the chunked default: BA lands at other boundaries
# (tests/test_cli.py holds the JAX runner to 0.05 m)
CHUNK_TOL_M = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread (see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds") / "seq"
    write_dataset(str(d), frames=10, loop=False, width=320, height=240,
                  depth_noise=0.0, seed=0)
    return str(d)


def _report(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _rows(path) -> np.ndarray:
    return np.loadtxt(path, ndmin=2)


@pytest.fixture(scope="module")
def jax_run(dataset, tmp_path_factory):
    """The JAX runner's default run, once for the file."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("jax") / "traj.txt"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main(["--dataset", dataset, "--out", str(out), "--cpu",
                         "--ate", "--no-prefetch"]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1]), _rows(out)


@pytest.fixture(scope="module")
def port_run(dataset, tmp_path_factory):
    """The port runner's default run, saving a checkpoint and a PLY map."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("port")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_main(["--dataset", dataset, "--out", str(d / "traj.txt"),
                          "--cpu", "--ate", "--no-prefetch",
                          "--save-checkpoint", str(d / "ck.npz"),
                          "--ply", str(d / "map.ply")]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1]), d


def test_default_run_matches_jax(jax_run, port_run):
    jrep, jrows = jax_run
    rep, d = port_run
    rows = _rows(d / "traj.txt")
    assert rep["frames"] == jrep["frames"] == 10
    assert rep["tracked_ok"] == jrep["tracked_ok"] == 10
    assert rep["keyframes"] == jrep["keyframes"]
    assert rows.shape == jrows.shape == (10, 8)
    np.testing.assert_array_equal(rows[:, 0], jrows[:, 0])
    np.testing.assert_allclose(rows[:, 1:], jrows[:, 1:], rtol=0,
                               atol=POSE_TOL_M)
    assert rep["ate"]["rmse"] == pytest.approx(jrep["ate"]["rmse"],
                                               abs=POSE_TOL_M)
    for key in ("loop_closures", "relocalizations", "fps", "wall_s"):
        assert key in rep


def test_per_frame_run_agrees_with_chunked(dataset, port_run, tmp_path,
                                           capsys):
    out = tmp_path / "p.txt"
    assert port_main(["--dataset", dataset, "--out", str(out), "--cpu",
                      "--no-prefetch", "--chunk", "1"]) == 0
    rep = _report(capsys)
    assert rep["frames"] == rep["tracked_ok"] == 10
    chunked = _rows(port_run[1] / "traj.txt")
    per_frame = _rows(out)
    assert per_frame.shape == chunked.shape
    assert float(np.abs(per_frame[:, 1:4] - chunked[:, 1:4]).max()) \
        < CHUNK_TOL_M


def test_checkpoint_and_ply(dataset, port_run, tmp_path, capsys):
    rep, d = port_run
    assert rep["ply_points"] > 0
    lines = (d / "map.ply").read_text().splitlines()
    assert lines[0] == "ply"
    assert f"element vertex {rep['ply_points']}" in lines
    # resume from the checkpoint, 3 more frames with the native prefetch
    out = tmp_path / "resumed.txt"
    assert port_main(["--dataset", dataset, "--out", str(out), "--cpu",
                      "--load-checkpoint", str(d / "ck.npz"),
                      "--max-frames", "3"]) == 0
    captured = capsys.readouterr()
    assert "resumed from" in captured.err
    resumed = json.loads(captured.out.strip().splitlines()[-1])
    assert resumed["frames"] == 13 and resumed["tracked_ok"] == 3
    assert resumed["keyframes"] >= rep["keyframes"]
    assert _rows(out).shape == (13, 8)


def test_kitti_format(dataset, tmp_path, capsys):
    out = tmp_path / "k.txt"
    assert port_main(["--dataset", dataset, "--out", str(out), "--cpu",
                      "--format", "kitti", "--pipeline", "odometry",
                      "--max-frames", "4", "--matcher", "hamming_2nn_xla"]) == 0
    assert _report(capsys)["tracked_ok"] == 4
    assert _rows(out).shape == (4, 12)


def test_without_cpu_flag_the_card_is_required(dataset):
    """No --cpu means the card: with none present the runner raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--dataset", dataset, "--max-frames", "1"])


def test_overrides_match_jax():
    sets = ["loop.min_score=0.05", "tracker.new_keyframe_min_inliers=300",
            "loop.global_ba_on_loop=false", "pnp.inlier_threshold_px=3"]
    got = dataclasses.asdict(apply_overrides(SlamConfig(), sets))
    want = dataclasses.asdict(jax_apply_overrides(JaxSlamConfig(), sets))
    assert got == want
    assert got["loop"]["min_score"] == 0.05
    for bad in ("loop.min_score", "nope.x=1", "loop.nope=1"):
        with pytest.raises(SystemExit):
            apply_overrides(SlamConfig(), [bad])
