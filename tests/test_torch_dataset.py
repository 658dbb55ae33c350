"""The port's dataset tools against the JAX package's, on the CPU:
`TumRgbdDataset` on data/sample (frames, timestamps, camera, ground
truth, `prefetch_iter`, `wire_iter`) byte-equal; the decoder chain, the
native loader against the numpy PNG codec; TUM and KITTI trajectories
written and read back; `write_dataset` files, `BoxSceneGenerator` and
`DegradedScene` frames byte-equal for the same arguments; the PLY export
and the live-camera provider's injected-backend contract."""

import filecmp
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import CameraConfig as JCameraConfig
from modular_slam_tpu.eval import synthetic as jsyn
from modular_slam_tpu.eval.make_dataset import \
    write_dataset as jax_write_dataset
from modular_slam_tpu.eval.ply import export_map_ply as jax_export_ply
from modular_slam_tpu.geometry.se3 import Pose as JPose
from modular_slam_tpu.io import KittiTrajectoryWriter as JKitti
from modular_slam_tpu.io import TumRgbdDataset as JaxDataset
from modular_slam_tpu.io import TumTrajectoryWriter as JTum
from modular_slam_tpu_torch.config import CameraConfig
from modular_slam_tpu_torch.eval import synthetic as tsyn
from modular_slam_tpu_torch.eval.make_dataset import write_dataset
from modular_slam_tpu_torch.eval.ply import export_map_ply
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.io import (KittiTrajectoryWriter, TumRgbdDataset,
                                       TumTrajectoryWriter, native,
                                       read_tum_trajectory, tum)
from modular_slam_tpu_torch.io.camera import (REALSENSE_DEPTH_FACTOR,
                                              WARMUP_FRAMES, LiveRgbdCamera)
from modular_slam_tpu_torch.utils import registry as reg
from modular_slam_tpu_torch.utils import state as port_state
from modular_slam_tpu_torch.viz.png import read_png, write_png

SAMPLE = os.path.join(os.path.dirname(__file__), "..", "data", "sample")


def _assert_same_frames(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for fa, fb in zip(a, b):
        for x, y in zip(fa[:2], fb[:2]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert fa[2] == fb[2]


def test_sample_dataset_equals_jax():
    ds, jds = TumRgbdDataset(SAMPLE), JaxDataset(SAMPLE)
    assert len(ds) == len(jds) == 16
    assert vars(ds.camera) == vars(jds.camera)
    np.testing.assert_array_equal(ds.timestamps(), jds.timestamps())
    np.testing.assert_array_equal(ds.groundtruth, jds.groundtruth)
    _assert_same_frames(ds, jds)
    _assert_same_frames(ds.prefetch_iter(n_threads=2, ring=2),
                        jds.prefetch_iter(n_threads=2, ring=2))
    _assert_same_frames(ds.wire_iter(n_threads=2, ring=2),
                        jds.wire_iter(n_threads=2, ring=2))
    _assert_same_frames(ds.wire_iter(native_ok=False),
                        jds.wire_iter(native_ok=False))
    gray, dep, _ = next(iter(ds.wire_iter()))
    assert gray.dtype == np.uint8 and dep.dtype == np.uint16


def test_native_decoder_agrees_with_read_png():
    assert native.available(), "native/png_loader.cpp did not build"
    ds = TumRgbdDataset(SAMPLE)
    for rec in ds.records[:3]:
        for path in (rec.rgb_path, rec.depth_path):
            np.testing.assert_array_equal(native.decode_png(path),
                                          read_png(path))
    assert native.decode_png("/nonexistent.png") is None


def test_decoder_chain_ends_with_read_png(monkeypatch):
    """With no native loader, OpenCV or PIL, the frames come from the
    numpy codec, equal to the JAX package's reader's."""
    monkeypatch.setattr(native, "decode_png", lambda path: None)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tum, "_cv2", None)
    monkeypatch.setattr(tum, "_PILImage", None)
    tum.DECODED.clear()
    ds, jds = TumRgbdDataset(SAMPLE), JaxDataset(SAMPLE)
    _assert_same_frames(ds.prefetch_iter(), jds)
    _assert_same_frames(ds.wire_iter(), jds.wire_iter(native_ok=False))
    assert set(tum.DECODED) == {"read_png"}
    assert tum.DECODED["read_png"] == 4 * len(ds)


def test_trajectory_writers_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    stamps = 100.0 + np.arange(6) / 30.0
    for port_cls, jax_cls, name in ((TumTrajectoryWriter, JTum, "tum"),
                                    (KittiTrajectoryWriter, JKitti,
                                     "kitti")):
        with port_cls(str(tmp_path / f"{name}.txt")) as w:
            for k in range(6):
                w.write(stamps[k], Pose(torch.from_numpy(q[k]),
                                        torch.from_numpy(t[k])))
        with jax_cls(str(tmp_path / f"jax_{name}.txt")) as w:
            for k in range(6):
                w.write(stamps[k], JPose(jnp.asarray(q[k]),
                                         jnp.asarray(t[k])))
        assert filecmp.cmp(tmp_path / f"{name}.txt",
                           tmp_path / f"jax_{name}.txt", shallow=False)
    rows = read_tum_trajectory(str(tmp_path / "tum.txt"))
    assert rows.shape == (6, 8)
    np.testing.assert_allclose(rows[:, 0], stamps, atol=1e-6)
    np.testing.assert_allclose(rows[:, 1:4], t, atol=1e-6)
    np.testing.assert_allclose(rows[:, 4:7], q[:, 1:], atol=1e-6)
    np.testing.assert_allclose(rows[:, 7], q[:, 0], atol=1e-6)
    kitti = np.loadtxt(tmp_path / "kitti.txt").reshape(6, 3, 4)
    np.testing.assert_allclose(kitti[:, :, 3], t, atol=1e-9)
    np.testing.assert_allclose(kitti[:, :, :3] @ kitti[:, :, :3].transpose(
        0, 2, 1), np.broadcast_to(np.eye(3), (6, 3, 3)), atol=1e-5)


def test_write_dataset_files_equal_jax(tmp_path):
    kw = dict(frames=3, laps=1, width=64, height=48, depth_noise=0.01,
              seed=2, radius=0.3)
    info = write_dataset(str(tmp_path / "port"), **kw)
    jax_write_dataset(str(tmp_path / "jax"), **kw)
    cmp = filecmp.dircmp(tmp_path / "port", tmp_path / "jax")
    assert not cmp.left_only and not cmp.right_only and not cmp.diff_files
    for sub in ("rgb", "depth"):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) == 3
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / "port" / sub, tmp_path / "jax" / sub, names,
            shallow=False)
        assert match == names, (mismatch, errors)
    ds = TumRgbdDataset(info["out"])
    assert ds.camera == info["camera"] and len(ds) == 3


def test_box_and_degraded_scenes_equal_jax():
    cam = dict(fx=100.0, fy=100.0, cx=79.5, cy=59.5, width=160, height=120)
    tbox = tsyn.BoxSceneGenerator(CameraConfig(**cam), seed=4,
                                  depth_noise=0.01)
    jbox = jsyn.BoxSceneGenerator(JCameraConfig(**cam), seed=4,
                                  depth_noise=0.01)
    tposes = tbox.yaw_trajectory(3, step_t=(0.02, 0.0, 0.01))
    jposes = jbox.yaw_trajectory(3, step_t=(0.02, 0.0, 0.01))
    for tp, jp in zip(tposes, jposes):
        for a, b in zip(tbox.render(tp), jbox.render(jp)):
            np.testing.assert_array_equal(a, b)
    tdeg = tsyn.DegradedScene(tsyn.PlaneSceneGenerator(
        CameraConfig(**cam), seed=6), seed=5)
    jdeg = jsyn.DegradedScene(jsyn.PlaneSceneGenerator(
        JCameraConfig(**cam), seed=6), seed=5)
    _assert_same_frames(tdeg.sequence(tdeg.trajectory(3)),
                        jdeg.sequence(jdeg.trajectory(3)))


def test_ply_export_equals_jax(tmp_path):
    from modular_slam_tpu.config import MapConfig
    from modular_slam_tpu.geometry.se3 import quat_from_axis_angle
    from modular_slam_tpu.map import add_keyframe, add_landmarks, empty_arena

    arena = empty_arena(MapConfig(max_keyframes=4, max_landmarks=16,
                                  max_observations=32, descriptor_bits=16))
    for k in range(2):
        pose = JPose(q=quat_from_axis_angle(jnp.array([0.1, 0.2 * k, 0.3])),
                     t=jnp.array([k, 2.0, -1.0]))
        arena, _ = add_keyframe(arena, pose, jnp.float32(k))
    arena, _ = add_landmarks(
        arena, jnp.asarray(np.random.default_rng(0).normal(size=(5, 3)),
                           jnp.float32),
        jnp.ones((5, 16), jnp.int8), jnp.arange(5) != 2)
    n = export_map_ply(str(tmp_path / "port.ply"), port_state.arena_from_numpy(
        jax.tree.map(np.asarray, arena)))
    assert n == jax_export_ply(str(tmp_path / "jax.ply"), arena) == 4 + 10
    assert filecmp.cmp(tmp_path / "port.ply", tmp_path / "jax.ply",
                       shallow=False)


def test_png_codec_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 256, (7, 9, 3), dtype=np.uint8),
                rng.integers(0, 256, (7, 9), dtype=np.uint8),
                rng.integers(0, 65536, (7, 9), dtype=np.uint16)):
        write_png(str(tmp_path / "x.png"), img)
        back = read_png(str(tmp_path / "x.png"))
        assert back.dtype == img.dtype
        np.testing.assert_array_equal(back, img)


class FakeRs:
    """A stand-in RealSense backend (tests/test_camera_provider.py)."""

    def __init__(self):
        self.calls = 0
        self.closed = False
        self.camera = CameraConfig(fx=600.0, fy=600.0, cx=320.0, cy=240.0,
                                   width=64, height=48,
                                   depth_factor=REALSENSE_DEPTH_FACTOR)

    def wait_for_frames(self):
        self.calls += 1
        return (np.full((48, 64, 3), self.calls % 256, dtype=np.uint8),
                np.full((48, 64), 1.5, dtype=np.float32),
                float(self.calls) / 30.0)

    def close(self):
        self.closed = True


def test_live_camera_contract():
    be = FakeRs()
    LiveRgbdCamera(backend=be)
    assert be.calls == WARMUP_FRAMES == 30
    be = FakeRs()
    cam = LiveRgbdCamera(backend=be, max_frames=3, warmup=0)
    frames = list(cam)
    assert len(frames) == 3 and be.closed
    rgb, depth, ts = frames[0]
    assert rgb.dtype == np.uint8 and rgb.shape == (48, 64, 3)
    assert depth.dtype == np.float32 and isinstance(ts, float)
    assert cam.camera.fx == 600.0
    assert cam.camera.depth_factor == REALSENSE_DEPTH_FACTOR
    with pytest.raises(RuntimeError, match="pyrealsense2"):
        LiveRgbdCamera()
    from modular_slam_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    live = reg.create("data_provider", "realsense", cfg, backend=FakeRs(),
                      warmup=0, max_frames=2)
    assert len(list(live)) == 2
    assert len(reg.create("data_provider", "tum_files", cfg, SAMPLE)) == 16
