"""The port's viewer subsystem (modular_slam_tpu_torch/viz/, viewer.py)
against the JAX package's on the CPU, and the JAX suite's cases
(tests/test_viz.py) on the port.

Exact: the drawing functions and the depth colormap (byte-equal images),
the overlay's `valid` and `kp_uv`; within 1e-6: `pointcloud_from_rgbd`
and `frustum_lines`; within 1e-4 px: the overlay's `lm_uv`.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import jax
import pytest

from modular_slam_tpu import config as jconfig
from modular_slam_tpu.viz import overlay as jov
from modular_slam_tpu.viz import scene as jscene
from modular_slam_tpu_torch import config as tconfig
from modular_slam_tpu_torch import viewer
from modular_slam_tpu_torch.utils import state as port_state
from modular_slam_tpu_torch.viz import overlay as tov
from modular_slam_tpu_torch.viz import scene as tscene

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _small_cam(mod):
    return mod.CameraConfig(fx=50.0, fy=50.0, cx=15.5, cy=11.5, width=32,
                            height=24)


def _overlay_cfg(mod):
    """tests/test_viz.py::test_overlay_fn_on_tracked_frames' config, from
    the classes of `mod` (the JAX or the port's config module)."""
    return mod.SlamConfig(
        camera=mod.CameraConfig(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                                width=320, height=240),
        detector=mod.DetectorConfig(n_levels=4, max_keypoints=384),
        map=mod.MapConfig(max_keyframes=32, max_landmarks=4096,
                          max_observations=16384),
        pnp=mod.PnpConfig(n_hypotheses=64),
    )


def _points(rng, n, lo=-20.0, hi=70.0):
    return rng.uniform(lo, hi, (n, 2)).astype(np.float32)


def test_drawing_is_byte_equal_to_jax():
    """Observation and keypoint overlays (points on, near and off the
    image) and the depth colormap, with and without explicit limits."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    kp, lm = _points(rng, 40), _points(rng, 40)
    valid = rng.random(40) < 0.7
    for radius in (1, 2, 3):
        np.testing.assert_array_equal(
            tov.draw_observations(rgb, kp, lm, valid, radius),
            jov.draw_observations(rgb, kp, lm, valid, radius))
        np.testing.assert_array_equal(
            tov.draw_keypoints(rgb, kp, valid, radius),
            jov.draw_keypoints(rgb, kp, valid, radius))
    depth = rng.uniform(0.3, 4.0, (48, 64)).astype(np.float32)
    depth[rng.random((48, 64)) < 0.1] = 0.0
    for lims in ((None, None), (1.0, 3.0), (2.0, None)):
        np.testing.assert_array_equal(tov.depth_colormap(depth, *lims),
                                      jov.depth_colormap(depth, *lims))
    empty = np.zeros((4, 5), np.float32)
    np.testing.assert_array_equal(tov.depth_colormap(empty),
                                  jov.depth_colormap(empty))


def test_pointcloud_and_frustum_match_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 12.0, (24, 32)).astype(np.float32)
    depth[rng.random((24, 32)) < 0.2] = 0.0
    rgb = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3).astype(np.float32)
    for pose in ((None, None), (q, t)):
        for stride in (1, 3):
            tp, tc = tscene.pointcloud_from_rgbd(
                rgb, depth, _small_cam(tconfig), *pose, stride=stride)
            jp, jc = jscene.pointcloud_from_rgbd(
                rgb, depth, _small_cam(jconfig), *pose, stride=stride)
            np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(tc, jc)
    for scale in (0.1, 0.25):
        np.testing.assert_allclose(
            tscene.frustum_lines(q, t, _small_cam(tconfig), scale),
            jscene.frustum_lines(q, t, _small_cam(jconfig), scale),
            rtol=0, atol=1e-6)


def test_depth_colormap_hot_ramp():
    depth = np.array([[0.0, 1.0, 2.0, 3.0]], np.float32)
    img = tov.depth_colormap(depth, dmin=1.0, dmax=3.0)
    assert img.shape == (1, 4, 3)
    assert (img[0, 0] == 0).all()                 # invalid -> black
    assert img[0, 1, 0] == 0                      # min -> black end of ramp
    assert (img[0, 3] == 255).all()               # max -> white
    assert img[0, 2, 0] >= img[0, 2, 1] >= img[0, 2, 2]


def test_draw_observations_colors():
    rgb = np.zeros((32, 32, 3), np.uint8)
    kp = np.array([[8.0, 8.0]], np.float32)
    lm = np.array([[24.0, 24.0]], np.float32)
    out = tov.draw_observations(rgb, kp, lm, np.array([True]))
    assert out[8, 8, 0] > 150 and out[8, 8, 2] < 100      # red keypoint
    assert out[24, 24, 2] > 150                            # blue landmark
    assert out[16, 16, 1] > 150                            # green line
    out2 = tov.draw_observations(rgb, kp, lm, np.array([False]))
    assert (out2 == 0).all()


def test_pointcloud_from_rgbd_geometry():
    cam = _small_cam(tconfig)
    depth = np.full((24, 32), 2.0, np.float32)
    rgb = np.full((24, 32, 3), 128, np.uint8)
    pts, cols = tscene.pointcloud_from_rgbd(rgb, depth, cam, stride=1)
    assert pts.shape == (24 * 32, 3)
    assert np.allclose(pts[:, 2], 2.0)
    center = pts[np.argmin(np.abs(pts[:, 0]) + np.abs(pts[:, 1]))]
    assert abs(center[0]) < 0.05 and abs(center[1]) < 0.05
    pts2, _ = tscene.pointcloud_from_rgbd(
        rgb, depth, cam, np.array([1.0, 0, 0, 0]), np.array([1.0, 2.0, 3.0]),
        stride=1)
    np.testing.assert_allclose(pts2, pts + np.array([1, 2, 3]), atol=1e-5)


def test_frustum_lines_shape():
    segs = tscene.frustum_lines(np.array([1.0, 0, 0, 0]), np.zeros(3),
                                _small_cam(tconfig), 0.2)
    assert segs.shape == (8, 2, 3)
    assert np.allclose(segs[0, 0], 0.0)
    assert np.allclose(segs[4:, :, 2], 0.2)


def test_overlay_on_tracked_frames_matches_jax():
    """Two tracked frames of the JAX engine (tests/test_viz.py's scene);
    its arena, state and features go to the port through utils/state,
    and the port's overlay (plain matcher on the CPU) gives the JAX
    overlay's pairs."""
    from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
    from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator

    jcfg = _overlay_cfg(jconfig)
    gen = PlaneSceneGenerator(jcfg.camera, seed=1)
    poses = gen.trajectory(2, step_t=(0.02, 0.0, 0.0))
    system = JaxSlamSystem(jcfg, enable_backend=False)
    frames = list(gen.sequence(poses))
    for rgb, depth, ts in frames:
        system.process(rgb, depth, ts)
    jod = jov.make_overlay_fn(jcfg)(system.arena, system.state,
                                    system.last_features)

    host = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    tod = tov.make_overlay_fn(_overlay_cfg(tconfig), device="cpu")(
        port_state.arena_from_numpy(host(system.arena)),
        port_state.track_state_from_numpy(host(system.state)),
        port_state.features_from_numpy(host(system.last_features)))
    valid = np.asarray(jod.valid)
    assert valid.sum() >= 5
    np.testing.assert_array_equal(tod.valid.numpy(), valid)
    np.testing.assert_array_equal(tod.kp_uv.numpy(), np.asarray(jod.kp_uv))
    np.testing.assert_allclose(tod.lm_uv.numpy(), np.asarray(jod.lm_uv),
                               rtol=0, atol=1e-4)
    kp, lm = tod.kp_uv.numpy()[valid], tod.lm_uv.numpy()[valid]
    assert np.median(np.linalg.norm(kp - lm, axis=1)) < 5.0
    over = tov.draw_observations(frames[-1][0], tod.kp_uv.numpy(),
                                 tod.lm_uv.numpy(), tod.valid.numpy())
    assert (over != frames[-1][0]).any()


def test_render_scene_writes_png(tmp_path):
    from modular_slam_tpu_torch.map.arena import empty_arena

    arena = empty_arena(tconfig.MapConfig(max_keyframes=4, max_landmarks=64,
                                          max_observations=128))
    traj = np.array([[0, 0, 0], [0.1, 0, 0]], np.float32)
    p = str(tmp_path / "scene.png")
    tscene.render_scene(p, arena, traj, cam=_small_cam(tconfig))
    assert open(p, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def _request(srv, path, body=None):
    req = urllib.request.Request(
        srv.url.rstrip("/") + path, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req) as r:
        return r.status, r.read()


def test_viewer_server_endpoints():
    from modular_slam_tpu_torch.utils.params import ParameterRegistry
    from modular_slam_tpu_torch.viz.server import ViewerServer

    srv = ViewerServer(port=0).start()
    try:
        params = ParameterRegistry()
        params.register_number("min_matched_points", 10, 0, 100)
        srv.state.params = params
        srv.state.publish_stats({"keyframes": 3, "fps": 12.5})
        srv.state.publish_frame(np.zeros((8, 8, 3), np.uint8))
        srv.state.publish_depth(np.zeros((8, 8, 3), np.uint8))

        st, body = _request(srv, "/")
        assert st == 200 and b"viewer" in body
        st, body = _request(srv, "/stats.json")
        assert st == 200 and json.loads(body)["keyframes"] == 3
        for path in ("/frame.png", "/depth.png", "/scene.png"):
            st, body = _request(srv, path)
            assert st == 200 and body[:8] == b"\x89PNG\r\n\x1a\n", path
        ps = json.loads(_request(srv, "/params")[1])
        assert ps[0]["name"] == "min_matched_points" and ps[0]["value"] == 10

        # write-back applies
        st, _ = _request(srv, "/params", {"name": "min_matched_points",
                                          "value": 25})
        assert st == 200 and params.get("min_matched_points") == 25
        with pytest.raises(urllib.error.HTTPError) as e:
            _request(srv, "/params", {"name": "min_matched_points",
                                      "value": 1000})
        assert e.value.code == 422
        assert params.get("min_matched_points") == 25

        _request(srv, "/control", {"action": "pause"})
        assert srv.state.paused.is_set()
        _request(srv, "/control", {"action": "stop"})
        assert srv.state.stopped.is_set()
        assert not srv.state.wait_if_paused()
    finally:
        srv.stop()


def test_viewer_main_writes_views_and_trajectory(tmp_path):
    out, traj = str(tmp_path / "views"), str(tmp_path / "traj.txt")
    ply = str(tmp_path / "map.ply")
    assert viewer.main(["--dataset", os.path.join(ROOT, "data", "sample"),
                        "--cpu", "--save-dir", out, "--max-frames", "6",
                        "--save-every", "5", "--out", traj,
                        "--ply", ply]) == 0
    for name in ("frame_000000.png", "depth_000000.png", "frame_000005.png",
                 "depth_000005.png", "scene.png"):
        with open(os.path.join(out, name), "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", name
    rows = np.loadtxt(traj)
    assert rows.shape == (6, 8) and np.isfinite(rows).all()
    with open(ply, "rb") as f:
        assert f.read(3) == b"ply"


class _Parsed(Exception):
    pass


def test_viewer_flags_match_jax(monkeypatch):
    """Flag for flag the JAX viewer's (`--cpu` selects the CPU in both)."""
    import argparse

    from modular_slam_tpu import viewer as jviewer

    def flags(mod):
        seen = {}

        def grab(self, argv=None, namespace=None):
            seen.update({a.dest: (a.option_strings, a.default, a.choices)
                         for a in self._actions if a.dest != "help"})
            raise _Parsed

        monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            mod.main(["--dataset", "x"])
        return seen

    assert flags(viewer) == flags(jviewer)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tov.make_overlay_fn(_overlay_cfg(tconfig))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        viewer.main(["--dataset", os.path.join(ROOT, "data", "sample"),
                     "--max-frames", "1"])
