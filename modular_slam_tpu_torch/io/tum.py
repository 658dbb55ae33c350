"""TUM-format RGB-D dataset reader and host -> device frames (counterpart
of modular_slam_tpu/io/tum.py).

- plain directory mode: `root/rgb/*.png` + `root/depth/*.png`, sorted and
  paired 1:1;
- TUM sequence mode: `root/rgb.txt` + `root/depth.txt` timestamped file
  lists, associated by nearest timestamp;
- depth PNGs are 16-bit, scaled by the camera's depth_factor (TUM:
  1/5000 m); rgb PNGs are 8-bit color; an `intrinsics.txt` written by
  eval/make_dataset.py gives the camera.

Decoders, in the JAX package's order: the native loader (io/native.py),
then OpenCV, then PIL — and, the port's own last link, the numpy PNG
codec `viz/png.read_png`, so a machine with none of the three still reads
the datasets eval/make_dataset.py writes (filter 0, which that decoder
reads quickly).  `DECODED` counts the images each decoder read.

`rgb_to_luma` and `frame_to_device` take host frames to the device.
"""

from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from modular_slam_tpu_torch.config import CameraConfig
from modular_slam_tpu_torch.io import native
from modular_slam_tpu_torch.io.associate import associate
from modular_slam_tpu_torch.types import LUMA_WEIGHTS, RgbdFrame
from modular_slam_tpu_torch.utils.device import constant, upload
from modular_slam_tpu_torch.viz.png import read_png

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")

# images read per decoder: "native", "cv2", "PIL", "read_png"; the
# prefetch threads' frames count as "native"
DECODED: collections.Counter = collections.Counter()

try:
    import cv2 as _cv2
except ImportError:
    _cv2 = None

try:
    from PIL import Image as _PILImage
except ImportError:
    _PILImage = None


def _decode(path: str, want_color: bool) -> np.ndarray:
    """The first decoder of the chain that reads `path`: uint8 [H,W,3] RGB
    when `want_color`, else the raw single-channel image."""
    img = native.decode_png(path)
    if img is not None and (img.ndim == 3) == want_color:
        DECODED["native"] += 1
        return img
    if _cv2 is not None:
        img = _cv2.imread(path, _cv2.IMREAD_COLOR if want_color
                          else _cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise FileNotFoundError(path)
        DECODED["cv2"] += 1
        return img[..., ::-1].copy() if want_color else img
    if _PILImage is not None:
        with _PILImage.open(path) as im:
            img = np.asarray(im.convert("RGB") if want_color else im)
        DECODED["PIL"] += 1
        return img
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: no decoder for this format")
    img = read_png(path)
    DECODED["read_png"] += 1
    if want_color and img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def load_rgb(path: str) -> np.ndarray:
    """Load an 8-bit color image as RGB uint8 [H, W, 3]."""
    return _decode(path, want_color=True)


def load_depth_raw(path: str) -> np.ndarray:
    """Load a 16-bit depth image as raw uint16 (no factor applied)."""
    return _decode(path, want_color=False).astype(np.uint16)


def load_depth(path: str, depth_factor: float) -> np.ndarray:
    """Load a 16-bit depth image -> float32 meters (0 = invalid)."""
    return _decode(path, want_color=False).astype(np.float32) * depth_factor


@dataclass
class FrameRecord:
    timestamp: float
    rgb_path: str
    depth_path: str


class TumRgbdDataset:
    """Lazy host-side RGB-D sequence."""

    _LUMA = np.array(LUMA_WEIGHTS, np.float32)

    def __init__(self, root: str, camera: Optional[CameraConfig] = None,
                 max_difference: float = 0.02):
        self.root = root
        # camera: explicit argument > intrinsics.txt > the TUM preset
        self.camera = camera or _read_intrinsics(
            os.path.join(root, "intrinsics.txt")) or CameraConfig()
        self.records: List[FrameRecord] = []

        rgb_txt = os.path.join(root, "rgb.txt")
        depth_txt = os.path.join(root, "depth.txt")
        if os.path.exists(rgb_txt) and os.path.exists(depth_txt):
            rgb_list = _read_file_list(rgb_txt, root)
            depth_list = _read_file_list(depth_txt, root)
            pairs = associate([t for t, _ in rgb_list],
                              [t for t, _ in depth_list],
                              max_difference=max_difference)
            for i, j in pairs:
                self.records.append(FrameRecord(
                    rgb_list[i][0], rgb_list[i][1], depth_list[j][1]))
        else:
            rgbs = _list_images(os.path.join(root, "rgb"))
            depths = _list_images(os.path.join(root, "depth"))
            if len(rgbs) != len(depths):
                raise ValueError(f"rgb/depth count mismatch: {len(rgbs)} vs "
                                 f"{len(depths)}")
            for k, (r, d) in enumerate(zip(rgbs, depths)):
                self.records.append(FrameRecord(float(k), r, d))
        if not self.records:
            raise ValueError(f"no frames found under {root}")

        # optional ground truth for evaluation
        self.groundtruth: Optional[np.ndarray] = None
        gt_txt = os.path.join(root, "groundtruth.txt")
        if os.path.exists(gt_txt):
            self.groundtruth = _read_trajectory_file(gt_txt)

    def __len__(self) -> int:
        return len(self.records)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray, float]:
        rec = self.records[idx]
        return (load_rgb(rec.rgb_path),
                load_depth(rec.depth_path, self.camera.depth_factor),
                rec.timestamp)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        for i in range(len(self)):
            yield self.load(i)

    def timestamps(self) -> np.ndarray:
        return np.array([r.timestamp for r in self.records])

    def _prefetcher(self, n_threads: int, ring: int,
                    to_gray: bool) -> Optional[native.PrefetchLoader]:
        if not native.available():
            return None
        return native.PrefetchLoader(
            [r.rgb_path for r in self.records],
            [r.depth_path for r in self.records],
            n_threads=n_threads, ring=ring, to_gray=to_gray)

    def prefetch_iter(self, n_threads: int = 4, ring: int = 8):
        """Iterate frames through the native decode-ahead loader; frames
        are decoded one by one when it is not available."""
        pl = self._prefetcher(n_threads, ring, to_gray=False)
        if pl is None:
            yield from self
            return
        with pl:
            for i, rec in enumerate(self.records):
                rgb, dep = pl.get(i)
                DECODED["native"] += 2
                yield (rgb, dep.astype(np.float32) * self.camera.depth_factor,
                       rec.timestamp)

    def wire_iter(self, n_threads: int = 4, ring: int = 8,
                  native_ok: bool = True):
        """Iterate frames in the wire format of
        `SlamSystem.process_chunk_wire`: (gray uint8 [H,W], raw depth
        uint16 [H,W], timestamp), 2.3x fewer bytes than rgb + float32
        depth.  The native loader converts to luma in its decode threads;
        without it the luma is rounded from `LUMA_WEIGHTS` in numpy."""
        pl = (self._prefetcher(n_threads, ring, to_gray=True)
              if native_ok else None)
        if pl is None:
            for rec in self.records:
                rgb = load_rgb(rec.rgb_path)
                gray = np.clip(np.round(rgb.astype(np.float32) @ self._LUMA),
                               0, 255).astype(np.uint8)
                yield gray, load_depth_raw(rec.depth_path), rec.timestamp
            return
        with pl:
            for i, rec in enumerate(self.records):
                gray, dep = pl.get(i)
                DECODED["native"] += 2
                yield gray, dep, rec.timestamp


def _list_images(d: str) -> List[str]:
    if not os.path.isdir(d):
        raise FileNotFoundError(d)
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith(_IMG_EXTS))


def _read_rows(path: str) -> List[List[str]]:
    """Whitespace-split fields of the non-empty, non-comment lines."""
    with open(path) as f:
        return [ln.split() for ln in (raw.strip() for raw in f)
                if ln and not ln.startswith("#")]


def _read_file_list(path: str, root: str) -> List[Tuple[float, str]]:
    return [(float(r[0]), os.path.join(root, r[1])) for r in _read_rows(path)]


def _read_intrinsics(path: str) -> Optional[CameraConfig]:
    """`fx fy cx cy depth_factor width height` on one non-comment line."""
    if not os.path.exists(path):
        return None
    rows = _read_rows(path)
    if not rows:
        return None
    v = rows[0]
    return CameraConfig(fx=float(v[0]), fy=float(v[1]), cx=float(v[2]),
                        cy=float(v[3]), depth_factor=float(v[4]),
                        width=int(v[5]), height=int(v[6]))


def _read_trajectory_file(path: str) -> np.ndarray:
    """TUM trajectory/groundtruth: rows `t x y z qx qy qz qw` -> [N, 8]."""
    rows = [[float(v) for v in r] for r in _read_rows(path)]
    return np.array([r[:8] for r in rows if len(r) >= 8],
                    dtype=np.float64).reshape(-1, 8)


def rgb_to_luma(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [...] float32 luma (frame.cpp:6-27 weights).

    Written as a chain of fused multiply-adds, r*w0 then + g*w1 then
    + b*w2: on the CPU this rounds exactly like the JAX package's
    tensordot, bit for bit (a float32 matmul does not)."""
    x = rgb.to(torch.float32)
    w = constant("luma_weights",
                 lambda: torch.tensor(LUMA_WEIGHTS, dtype=torch.float32),
                 rgb.device)
    g = x[..., 0] * w[0]
    g = torch.addcmul(g, x[..., 1], w[1])
    return torch.addcmul(g, x[..., 2], w[2])


def frame_to_device(rgb: np.ndarray, depth: np.ndarray, timestamp: float,
                    device="cpu") -> RgbdFrame:
    """Host numpy frame -> RgbdFrame on `device`, with luma grayscale;
    the copies to the card wait for nothing queued there."""
    rgb_d = upload(rgb, device)
    return RgbdFrame(
        rgb=rgb_d,
        gray=rgb_to_luma(rgb_d),
        depth=upload(np.asarray(depth, dtype=np.float32), device),
        timestamp=upload(np.asarray(timestamp, dtype=np.float32), device),
    )
