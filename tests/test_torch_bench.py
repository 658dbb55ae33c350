"""The port's benchmark, `modular_slam_tpu_torch/bench.py`, against the
repository's `bench.py` on the CPU.

- `_sequence`: the port renders `bench.py`'s frames exactly (rgb, depth,
  timestamps, poses): the plane sequence in full, the box sequence (a
  ray-cast of ~1 s a frame in each package) at its first 3 frames;
- the host helpers `_gt_rows`, `_rodrigues`, `_numpy_local_ba` and
  `_score_closures` (on a synthetic closure log): exactly equal;
- `bench_ours_tracking` and `bench_ours_full` (pipelined) at
  `tiny_test_config()`, on a 35-frame sequence that JAX tracks in full,
  with the JAX engine's RANSAC draws replayed (tests/test_torch_engine.py,
  tests/test_torch_chunked.py): the tracked and keyframe counts equal
  JAX's, and the full run's frames, flags and keyframe poses as the
  chunked tests hold them.  Its map pools are larger than the tiny
  config's (64 / 4096 / 16384): this sequence inserts a keyframe on most
  frames, and the tracking path never compacts, so the tiny pools fill
  and both engines lose the track;
- the headline's keys are `bench.py`'s plus `gpu` (read with `ast`), and
  the ported functions take `bench.py`'s calls (its positional
  parameters, `key` as `sampler`, the port's extras keyword-only).
"""

import ast
import dataclasses
import os
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch

from modular_slam_tpu.config import MapConfig as JMapConfig
from modular_slam_tpu.config import tiny_test_config as jax_tiny_config
from modular_slam_tpu_torch import bench as tbench
from modular_slam_tpu_torch.config import MapConfig, tiny_test_config
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.geometry.se3 import Pose
from tests.test_torch_api_parity import def_api, signature_problems
from tests.test_torch_chunked import _assert_same_results, _record
from tests.test_torch_engine import JaxKeyQueue

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import bench  # noqa: E402  (the repository's JAX benchmark)

TINY_FRAMES = 35      # WARMUP 3 + CHUNK 16 + one timed chunk of 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread for this file (see
    tests/test_torch_engine.py: the suite's worker processes share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("generator,n_frames", [("plane", None),
                                                ("box", 3)])
def test_sequence_renders_bench_frames(monkeypatch, generator, n_frames):
    if n_frames is not None:
        monkeypatch.setattr(bench, "N_FRAMES", n_frames)
        monkeypatch.setattr(tbench, "N_FRAMES", n_frames)
    jcfg, jframes, jposes = bench._sequence(generator)
    cfg, frames, poses = tbench._sequence(generator)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert len(frames) == len(jframes) == (n_frames or 67)
    for (rgb, depth, ts), (jrgb, jdepth, jts) in zip(frames, jframes):
        np.testing.assert_array_equal(rgb, np.asarray(jrgb))
        np.testing.assert_array_equal(depth, np.asarray(jdepth))
        assert ts == jts
    for p, jp in zip(poses, jposes):
        np.testing.assert_array_equal(p.q, np.asarray(jp.q))
        np.testing.assert_array_equal(p.t, np.asarray(jp.t))
    np.testing.assert_array_equal(tbench._gt_rows(poses),
                                  bench._gt_rows(jposes))


def test_proxy_helpers_equal_bench():
    rng = np.random.default_rng(7)
    for rvec in rng.normal(0, 0.3, (5, 3)):
        np.testing.assert_array_equal(tbench._rodrigues(rvec),
                                      bench._rodrigues(rvec))
    # a 3-keyframe window, 40 landmarks, noisy camera-frame observations
    K, L = 3, 40
    X = rng.uniform([-1, -1, 2], [1, 1, 4], (L, 3))
    poses = [(bench._rodrigues(rng.normal(0, 0.05, 3)),
              rng.normal(0, 0.1, 3)) for _ in range(K)]
    obs = [(k, l, poses[k][0] @ X[l] + poses[k][1]
            + rng.normal(0, 0.01, 3)) for k in range(K) for l in range(L)
           if (k + l) % 4]
    X0 = X + rng.normal(0, 0.02, X.shape)
    out = tbench._numpy_local_ba(poses, X0, obs)
    ref = bench._numpy_local_ba(poses, X0, obs)
    for (R, t), (jR, jt) in zip(out[0], ref[0]):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(out[1], ref[1])
    assert out[2] == ref[2]


def _closure_log(as_tensor):
    """A synthetic run: 24 keyframes over two laps of 12 ground-truth
    places, closures true and false, some revisits map-connected."""
    rng = np.random.default_rng(3)
    n_kf, L = 24, 64
    a = 2 * np.pi * np.arange(36) / 36
    poses = [Pose(q=np.array([1.0, 0, 0, 0], np.float32),
                  t=np.array([0.8 * np.sin(x), 0.8 * (1 - np.cos(x)), 0.0],
                             np.float32)) for x in a] * 2
    kf_time = np.arange(n_kf, dtype=np.float32) * 3 / 30.0
    kf_valid = np.ones(n_kf, bool)
    kf_valid[5] = False
    inc = rng.random((n_kf, L)) < 0.3
    inc[14] |= inc[2]           # a revisit the map already connects
    gt = np.array([np.asarray(p.t) for p in poses])
    closures = [(13, 1, 40, 0.31, tuple(gt[39] + 0.05)),     # true
                (16, 4, 33, 0.12, tuple(gt[48] + 0.6)),      # false
                (20, 8, 52, 0.45, tuple(gt[60] - 0.1))]      # true
    arena = types.SimpleNamespace(
        kf_time=torch.from_numpy(kf_time) if as_tensor else kf_time,
        kf_valid=torch.from_numpy(kf_valid) if as_tensor else kf_valid,
        inc=torch.from_numpy(inc) if as_tensor else inc)
    system = types.SimpleNamespace(
        arena=arena,
        _loop=types.SimpleNamespace(closures=closures, n_verify_rejects=4),
        cfg=types.SimpleNamespace(loop=types.SimpleNamespace(
            max_covis_overlap=12, closure_cooldown_keyframes=2)))
    return system, poses


@pytest.mark.parametrize("min_gap", [2, 6])
def test_score_closures_equals_bench(min_gap):
    system, poses = _closure_log(as_tensor=True)
    jsystem, _ = _closure_log(as_tensor=False)
    out = tbench._score_closures(system, poses, min_gap)
    assert out == bench._score_closures(jsystem, poses, min_gap)
    assert out["true_positives"] == 2 and out["false_positives"] == 1


def _tiny_pair():
    """(JAX config, port config, frames) of the tiny replay sequence."""
    pools = dict(max_keyframes=64, max_landmarks=4096, max_observations=16384)
    jcfg = jax_tiny_config().replace(map=JMapConfig(**pools))
    cfg = tiny_test_config().replace(map=MapConfig(**pools))
    gen = PlaneSceneGenerator(cfg.camera, seed=42, texture_ppm=100.0)
    poses = gen.trajectory(TINY_FRAMES, step_t=(0.005, 0.002, 0.0),
                           step_rot=(0.001, 0.002, 0.0))
    return jcfg, cfg, list(gen.sequence(poses))


def _tracked(err: str):
    m = re.findall(r"ours tracking: (\d+) frames in [\d.]+s, (\d+)/(\d+) "
                   r"tracked ok", err)
    assert len(m) == 1, err
    return tuple(int(x) for x in m[0])


def test_tracking_and_full_match_bench_on_replayed_draws(monkeypatch,
                                                         capsys):
    from modular_slam_tpu.models import pipelines as jax_pipelines

    jcfg, cfg, frames = _tiny_pair()

    # tracking: JAX's keys are split(PRNGKey(0), frames); each frame's
    # tracker key is the first of split(key); the bootstrap frame draws
    # nothing
    bench.bench_ours_tracking(jcfg, frames)
    jax_counts = _tracked(capsys.readouterr().err)
    keys = jax.random.split(jax.random.PRNGKey(0), len(frames))
    queue = JaxKeyQueue()
    queue.keys = [jax.random.split(k)[0] for k in keys[1:]]
    detail = {}
    tbench.bench_ours_tracking(cfg, frames, device="cpu", sampler=queue,
                               detail=detail)
    assert _tracked(capsys.readouterr().err) == jax_counts
    assert not queue.keys
    n = len(frames) - tbench.WARMUP - tbench.CHUNK
    assert jax_counts == (n, n, n) and detail["tracked_ok"] == n
    assert len(detail["chunk_host_ms"]) == n // tbench.CHUNK
    assert detail["chunk_ms"] is None          # no CUDA events on the CPU

    # the slam preset, deferred-pipelined: the JAX engine's draws recorded
    # in the port's order by wrapping its step and scan
    queue = JaxKeyQueue()
    systems = []
    slam_pipeline = jax_pipelines.slam_pipeline

    def recorded(c, **kw):
        systems.append(slam_pipeline(c, **kw))
        _record(systems[-1], queue)
        return systems[-1]

    monkeypatch.setattr(jax_pipelines, "slam_pipeline", recorded)
    _, j_kf, j_ok, jsys = bench.bench_ours_full(jcfg, frames)
    _, t_kf, t_ok, tsys = tbench.bench_ours_full(cfg, frames, device="cpu",
                                                 sampler=queue)
    # the first chunk is warm-up; the timed ones end at the last whole one
    assert (t_kf, t_ok) == (j_kf, j_ok) == (j_kf, len(jsys.results)) \
        == (j_kf, len(frames) // tbench.CHUNK * tbench.CHUNK)
    assert j_kf > 2
    _assert_same_results(jsys, tsys, queue)


def _headline_keys(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "headline"
                        for t in node.targets)):
            return {ast.literal_eval(k) for k in node.value.keys}
    raise AssertionError(f"no headline dict in {path}")


def test_headline_keys_are_bench_keys_and_gpu():
    port = _headline_keys(tbench.__file__)
    assert port == _headline_keys(os.path.join(ROOT, "bench.py")) | {"gpu"}


PORTED_PRIVATE = ("_sequence", "_stage_frames", "_score_closures",
                  "_rodrigues", "_numpy_local_ba", "_gt_rows",
                  "_load_pinned_baseline")


def test_functions_take_bench_calls():
    path = os.path.join(ROOT, "bench.py")
    api = def_api(path)
    with open(path) as f:
        tree = ast.parse(f.read())
    api.update({n.name: n for n in tree.body
                if isinstance(n, ast.FunctionDef)
                and n.name in PORTED_PRIVATE})
    assert set(PORTED_PRIVATE) <= set(api) and "bench_loop" in api
    problems = []
    for name, fn in sorted(api.items()):
        port_obj = getattr(tbench, name, None)
        if port_obj is None:
            problems.append(f"{name}: no such function in the port")
            continue
        problems += signature_problems("bench", name, fn, port_obj)
    assert not problems, "\n".join(problems)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg, frames = _tiny_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.bench_ours_tracking(cfg, frames)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main([])
