"""Live RGB-D camera data provider, RealSense (counterpart of
modular_slam_tpu/io/camera.py, numpy-only).

- depth frames aligned to the color stream;
- intrinsics and depth scale read from the device (0.001 m/unit when it
  does not say);
- a 30-frame warm-up at construction so auto-exposure settles;
- color delivered as RGB uint8 [H, W, 3].

`pyrealsense2` is imported only when no backend is injected, and its
absence raises a clear error.  Any injected `backend` with
`wait_for_frames() -> (rgb, depth_m, timestamp)` (and optionally a
`camera` and `close()`) stands in for the device: the tests exercise the
provider's contract that way.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from modular_slam_tpu_torch.config import CameraConfig

REALSENSE_DEPTH_FACTOR = 0.001  # meters per depth unit (:36-38)
WARMUP_FRAMES = 30  # (:15-26)


class LiveRgbdCamera:
    """Pull-model live RGB-D provider with the dataset iterator contract.

    Yields (rgb uint8 [H,W,3], depth float32 meters [H,W], timestamp s)
    exactly like `TumRgbdDataset`, so `SlamSystem.run` and the CLI accept
    it interchangeably (the reference swaps RgbdFileProvider for
    RealSenseCamera behind DataProviderInterface the same way,
    app/slam/rgbd_slam.cpp:61-74).
    """

    def __init__(self, width: int = 640, height: int = 480, fps: int = 30,
                 max_frames: Optional[int] = None, backend=None,
                 warmup: int = WARMUP_FRAMES):
        self.max_frames = max_frames
        self._backend = backend
        self.camera: Optional[CameraConfig] = None
        if backend is not None:
            self.camera = getattr(backend, "camera", None) or CameraConfig(
                width=width, height=height,
                depth_factor=REALSENSE_DEPTH_FACTOR)
            for _ in range(warmup):
                backend.wait_for_frames()
            return

        try:
            import pyrealsense2 as rs  # type: ignore
        except ImportError as e:  # pragma: no cover - no SDK installed
            raise RuntimeError(
                "LiveRgbdCamera needs pyrealsense2 (librealsense SDK) or an "
                "injected backend; neither is available. Use a TumRgbdDataset "
                "for file playback.") from e

        # pragma: no cover start - requires physical hardware
        self._rs = rs
        self._pipe = rs.pipeline()
        rs_cfg = rs.config()
        rs_cfg.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
        rs_cfg.enable_stream(rs.stream.color, width, height, rs.format.rgb8, fps)
        profile = self._pipe.start(rs_cfg)
        # depth aligned onto the color stream (realsense_camera.cpp:31)
        self._align = rs.align(rs.stream.color)
        intr = (profile.get_stream(rs.stream.color)
                .as_video_stream_profile().get_intrinsics())
        # devices report their own depth scale (SR300: 0.000125, D4xx:
        # 0.001); trust the device, fall back to the reference constant
        try:
            self._depth_scale = float(
                profile.get_device().first_depth_sensor().get_depth_scale())
        except Exception:
            self._depth_scale = REALSENSE_DEPTH_FACTOR
        self.camera = CameraConfig(
            fx=float(intr.fx), fy=float(intr.fy),
            cx=float(intr.ppx), cy=float(intr.ppy),
            width=int(intr.width), height=int(intr.height),
            depth_factor=self._depth_scale)
        for _ in range(warmup):  # auto-exposure settle (:15-26)
            self._pipe.wait_for_frames()
        # pragma: no cover end

    def _next(self) -> Tuple[np.ndarray, np.ndarray, float]:
        if self._backend is not None:
            return self._backend.wait_for_frames()
        # tolerate occasional dropped frames in a long live stream: a
        # frameset can arrive with a null color/depth frame; retry
        for _ in range(100):
            frames = self._align.process(self._pipe.wait_for_frames())
            cf, df = frames.get_color_frame(), frames.get_depth_frame()
            if cf and df:
                break
        else:
            raise RuntimeError("camera delivered 100 incomplete framesets")
        color = np.asanyarray(cf.get_data())
        depth = np.asanyarray(df.get_data())
        ts = float(frames.get_timestamp()) * 1e-3  # ms -> s
        return (color.astype(np.uint8),
                depth.astype(np.float32) * self._depth_scale, ts)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        n = 0
        try:
            while self.max_frames is None or n < self.max_frames:
                yield self._next()
                n += 1
        finally:
            self.close()

    def close(self) -> None:
        if self._backend is not None:
            closer = getattr(self._backend, "close", None)
            if callable(closer):
                closer()
        elif hasattr(self, "_pipe"):
            self._pipe.stop()

    def __enter__(self) -> "LiveRgbdCamera":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
