"""The slice as a whole: the port's odometry SlamSystem against the JAX
engine on the CPU, frame by frame.

RANSAC draws are replayed: the port's sampler below repeats the JAX
engine's key schedule — PRNGKey(seed), one split per frame
(engine.py:312), `jax.random.choice` with the probabilities of
pnp.py:211-215 on the port's own `valid` mask — so both engines score the
same hypotheses.  Result codes, tracking and keyframe decisions, match and
inlier counts must then be equal, and poses agree within 1e-4.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import MapConfig, tiny_test_config
from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator as JaxScene
from modular_slam_tpu.frontend.tracker import TrackState as JTrackState
from modular_slam_tpu.geometry.se3 import Pose as JPose
from modular_slam_tpu.io import TumRgbdDataset
from modular_slam_tpu.map.arena import MapArena as JMapArena
from modular_slam_tpu_torch.engine import SlamSystem
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.utils import state as port_state

POSE_TOL = 1e-4
SAMPLE = os.path.join(os.path.dirname(__file__), "..", "data", "sample")


class JaxKeyReplay:
    """RANSAC sampler replaying the JAX engine's draws.  `key` is the
    engine key before the next frame; the port calls the sampler once per
    tracked frame, and the JAX engine splits once per frame, so the
    bootstrap frame's split is skipped when starting from frame 0."""

    def __init__(self, key, at_first_frame=True):
        self.key = key
        if at_first_frame:
            self.key, _ = jax.random.split(self.key)

    def __call__(self, valid, n_hyp):
        self.key, sub = jax.random.split(self.key)
        v = jnp.asarray(valid.cpu().numpy())
        probs = v.astype(jnp.float32) + 1e-9
        probs = probs / jnp.sum(probs)
        idx = jax.random.choice(sub, v.shape[0], (n_hyp, 3), replace=True,
                                p=probs)
        return torch.from_numpy(np.array(idx)).long()


def _assert_same_frame(k, jsys, jcode, tsys, tcode):
    jr, tr = jsys.results[-1], tsys.results[-1]
    assert tcode.name == jcode.name, k
    for f in ("tracking_ok", "new_keyframe", "n_matches", "n_inliers",
              "kf_slot"):
        assert int(getattr(tr, f)) == int(getattr(jr, f)), (k, f)
    np.testing.assert_allclose(tr.pose.t.numpy(), np.asarray(jr.pose.t),
                               rtol=0, atol=POSE_TOL, err_msg=str(k))
    np.testing.assert_allclose(tr.pose.q.numpy(), np.asarray(jr.pose.q),
                               rtol=0, atol=POSE_TOL, err_msg=str(k))


def _run_both(cfg, frames, seed=0):
    jsys = JaxSlamSystem(cfg, seed=seed, enable_backend=False)
    tsys = SlamSystem(cfg, device="cpu",
                      sampler=JaxKeyReplay(jax.random.PRNGKey(seed)))
    for k, f in enumerate(frames):
        _assert_same_frame(k, jsys, jsys.process(*f), tsys, tsys.process(*f))
    return jsys, tsys


def test_numpy_scene_renders_the_jax_frames():
    cfg = tiny_test_config()
    jgen = JaxScene(cfg.camera, seed=5, texture_ppm=100.0)
    tgen = PlaneSceneGenerator(cfg.camera, seed=5, texture_ppm=100.0)
    jposes = (jgen.trajectory(3, step_t=(0.01, 0.004, -0.002),
                              step_rot=(0.01, 0.03, 0.02))
              + jgen.yaw_trajectory(2) + jgen.loop_trajectory(4)[1:2])
    tposes = (tgen.trajectory(3, step_t=(0.01, 0.004, -0.002),
                              step_rot=(0.01, 0.03, 0.02))
              + tgen.yaw_trajectory(2) + tgen.loop_trajectory(4)[1:2])
    for jp, tp in zip(jposes, tposes):
        np.testing.assert_array_equal(tp.q, np.asarray(jp.q))
        np.testing.assert_array_equal(tp.t, np.asarray(jp.t))
        for a, b in zip(tgen.render(tp), jgen.render(jp)):
            np.testing.assert_array_equal(a, b)


def test_odometry_matches_jax_on_plane_sequence_and_after_state_carry():
    cfg = tiny_test_config()
    gen = PlaneSceneGenerator(cfg.camera, seed=2, texture_ppm=100.0)
    poses = gen.trajectory(9, step_t=(0.005, 0.002, 0.0),
                           step_rot=(0.001, 0.002, 0.0))
    frames = list(gen.sequence(poses))
    jsys, tsys = _run_both(cfg, frames[:8])
    kf = [bool(r.new_keyframe) for r in tsys.results]
    assert all(bool(r.tracking_ok) for r in tsys.results)
    assert any(kf[1:]) and not all(kf[1:])  # both keyframe branches ran

    # carry the JAX engine's mid-sequence map and state into a fresh port
    # engine; one more frame must agree
    arena_np = jax.tree.map(np.asarray, jsys.arena)
    state_np = jax.tree.map(np.asarray, jsys.state)
    carried = SlamSystem(cfg, device="cpu",
                         sampler=JaxKeyReplay(jsys._key,
                                              at_first_frame=False))
    carried.arena = port_state.arena_from_numpy(arena_np)
    carried.state = port_state.track_state_from_numpy(state_np)
    _assert_same_frame(8, jsys, jsys.process(*frames[8]), carried,
                       carried.process(*frames[8]))

    # and the inverse conversions give back the JAX NamedTuples
    back = port_state.arena_to_numpy(carried.arena)
    JMapArena(**back)  # every field present
    st = port_state.track_state_to_numpy(carried.state)
    JTrackState(pose=JPose(**st.pop("pose")), **st)
    feats = port_state.features_to_numpy(carried.last_features)
    assert feats["descriptors"]["packed"].dtype == np.uint32
    np.testing.assert_array_equal(
        port_state.features_from_numpy(
            jax.tree.map(np.asarray, jsys.last_features)).descriptors.packed
        .numpy(), np.asarray(jsys.last_features.descriptors.packed)
        .view(np.int32))


def test_odometry_matches_jax_on_bundled_sample():
    """data/sample (16 rendered 320x240 frames), loaded by the JAX
    package's own loader; both engines get the same arrays."""
    ds = TumRgbdDataset(SAMPLE)
    cfg = tiny_test_config(240, 320).replace(
        camera=ds.camera,
        map=MapConfig(max_keyframes=16, max_landmarks=2048,
                      max_observations=8192))
    frames = list(ds)
    assert len(frames) == 16
    _, tsys = _run_both(cfg, frames)
    assert all(bool(r.tracking_ok) for r in tsys.results)
    assert tsys.n_keyframes > 2


def test_unported_features_raise():
    cfg = tiny_test_config()
    for kw in ({"enable_backend": True}, {"enable_loop_closure": True},
               {"enable_relocalization": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SlamSystem(cfg, device="cpu", **kw)
    from modular_slam_tpu_torch.models import make_pipeline

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_pipeline("slam", cfg, device="cpu")
    assert isinstance(make_pipeline("odometry", cfg, device="cpu"),
                      SlamSystem)


def test_highwater_raises_until_lifecycle_is_ported():
    """The JAX engine compacts the map when a pool crosses the highwater
    mark; the port raises there instead of diverging from it."""
    base = tiny_test_config()
    cfg = base.replace(map=MapConfig(max_keyframes=16, max_landmarks=24,
                                     max_observations=2048))
    gen = PlaneSceneGenerator(cfg.camera, seed=2, texture_ppm=100.0)
    frame = next(gen.sequence(gen.trajectory(1)))
    with pytest.raises(NotImplementedError, match="highwater"):
        SlamSystem(cfg, device="cpu").process(*frame)


@pytest.mark.parametrize("entry", ["SlamSystem", "make_slam_step",
                                   "make_pipeline"])
def test_entry_points_default_to_the_card(entry):
    """With no device the entry points take "cuda": on a machine with no
    CUDA device they raise instead of running on the CPU."""
    from modular_slam_tpu_torch.engine import make_slam_step
    from modular_slam_tpu_torch.models import make_pipeline

    cfg = tiny_test_config()
    build = {"SlamSystem": lambda: SlamSystem(cfg),
             "make_slam_step": lambda: make_slam_step(cfg),
             "make_pipeline": lambda: make_pipeline("odometry", cfg)}[entry]
    if torch.cuda.is_available():
        made = build()
        if isinstance(made, SlamSystem):
            assert made.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
