"""The box room, rendered on the device from a seed, and the camera paths
of the configurations.

The room is the port's `eval/synthetic.py::BoxSceneGenerator`: a back
wall, a floor and textured boxes at several depths, every pixel an
analytic ray-rectangle intersection with a z-buffer, so the ground truth
is exact.  `render_numpy` is a frozen copy of that generator's ray cast
(the tests hold `render` to it); `render` does the same in PyTorch on the
card for a batch of poses, and `make_texture` paints the generator's
blobby texture there from a `torch.Generator`, so that a bank of frames
costs seconds.  Depth gets the Kinect's axial noise (Nguyen, Izadi and
Lovell, 3DIMPVT 2012: sigma(z) = 0.0012 + 0.0019 (z - 0.4)^2 m) and is
then quantised to TUM's 16-bit depth images (1/5000 m).

Poses here are camera-to-world (R [.., 3, 3], t [.., 3]); +z forward,
+y down (the floor at +y).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

TEXTURE_SIZE = 4096
TEXTURE_PPM = 400.0


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class Rect(NamedTuple):
    origin: np.ndarray    # [3]
    eu: np.ndarray        # [3]
    ev: np.ndarray        # [3]
    su: float
    sv: float
    tex_off: Tuple[float, float]


def room_rects(rng: np.random.Generator, n_boxes: int,
               texture_size: int = TEXTURE_SIZE) -> List[Rect]:
    """The generator's room: back wall z = 3.2, floor y = +1.0, and
    `n_boxes` boxes (front, top and one side face) on the floor."""
    ex, ey, ez = np.eye(3)
    T = texture_size

    def off():
        return (float(rng.integers(0, T // 2)), float(rng.integers(0, T // 2)))

    rects = [Rect(np.array([-5.0, -2.0, 3.2]), ex, ey, 10.0, 4.0, off()),
             Rect(np.array([-5.0, 1.0, 0.3]), ex, ez, 10.0, 4.0, off())]
    for _ in range(n_boxes):
        s = float(rng.uniform(0.3, 0.6))
        h = float(rng.uniform(0.4, 0.9))
        xc = float(rng.uniform(-2.2, 2.2))
        zf = float(rng.uniform(1.3, 2.6))
        y_top = 1.0 - h
        o = np.array([xc - s / 2, y_top, zf])
        rects.append(Rect(o, ex, ey, s, h, off()))
        rects.append(Rect(o, ex, ez, s, s, off()))
        side_x = xc + s / 2 if xc < 0 else xc - s / 2
        rects.append(Rect(np.array([side_x, y_top, zf]), ez, ey, s, h, off()))
    return rects


def make_texture(gen: torch.Generator, size: int, device) -> torch.Tensor:
    """The generator's texture on the device: 128 grey, (size // 8)^2
    squares of side 3-9 px and uniform grey painted in order (a later
    square covers an earlier one), then OpenCV's 3x3 Gaussian blur of
    sigma 0.8 with reflect-101 borders."""
    n = (size // 8) ** 2
    ys = torch.randint(0, size - 12, (n,), generator=gen, device=device)
    xs = torch.randint(0, size - 12, (n,), generator=gen, device=device)
    side = torch.randint(3, 10, (n,), generator=gen, device=device)
    val = torch.rand(n, generator=gen, device=device) * 255.0
    top = torch.full((size * size + 1,), -1, dtype=torch.int64, device=device)
    d = torch.arange(9, device=device)
    dy, dx = d.repeat_interleave(9), d.repeat(9)                  # [81]
    keep = (dy[None] < side[:, None]) & (dx[None] < side[:, None])
    flat = (ys[:, None] + dy[None]) * size + xs[:, None] + dx[None]
    ids = torch.arange(n, device=device)[:, None].expand(n, 81)
    top.scatter_reduce_(0, torch.where(keep, flat, size * size).reshape(-1),
                        ids.reshape(-1), reduce="amax")
    top = top[:-1]
    tex = torch.where(top >= 0, val[top.clamp(min=0)],
                      torch.full_like(val[:1], 128.0)).reshape(size, size)
    x = np.arange(-1, 2, dtype=np.float64)
    k = np.exp(-0.5 * (x / 0.8) ** 2)
    k = torch.tensor(k / k.sum(), dtype=torch.float32, device=device)
    pad = torch.nn.functional.pad(tex[None, None], (1, 1, 1, 1),
                                  mode="reflect")[0, 0]
    rows = sum(k[i] * pad[:, i:i + size] for i in range(3))
    return sum(k[i] * rows[i:i + size, :] for i in range(3))


def _rays(cam: Camera, device, dtype) -> torch.Tensor:
    vs, us = torch.meshgrid(torch.arange(cam.height, dtype=dtype, device=device),
                            torch.arange(cam.width, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                        torch.ones_like(us)], dim=-1)      # [H, W, 3]


def _dot(xyz, v) -> torch.Tensor:
    """Component-wise dot of a ray field (x, y, z) with a constant
    3-vector, skipping its zero components."""
    out = 0.0
    for comp, c in zip(xyz, v):
        if c != 0.0:
            out = out + comp * float(c)
    return out


def render(cam: Camera, rects: List[Rect], tex: torch.Tensor,
           R: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Luma and depth [F, H, W] float32 of the poses R [F, 3, 3],
    t [F, 3] (float64, on the texture's device): the nearest surface per
    pixel, bilinear in the texture, 0 where no surface is hit."""
    dev, f64 = tex.device, torch.float64
    dirs = torch.einsum("hwj,fij->ifhw", _rays(cam, dev, f64), R)
    xyz = tuple(dirs)                                  # 3 x [F, H, W]
    zbuf = torch.full(dirs.shape[1:], math.inf, dtype=f64, device=dev)
    gray = torch.zeros(dirs.shape[1:], dtype=f64, device=dev)
    Th, Tw = tex.shape
    flat = tex.to(f64).reshape(-1)
    tcpu = t.cpu().numpy()
    for rc in rects:
        n = np.cross(rc.eu, rc.ev)
        dn = _dot(xyz, n)
        dn = torch.where(dn.abs() < 1e-9, torch.full_like(dn, 1e-9), dn)
        rel0 = tcpu - rc.origin                         # [F, 3]: t - o
        per_frame = lambda a: torch.as_tensor(a, dtype=f64, device=dev)[:, None, None]  # noqa: E731
        lam = per_frame(-(rel0 @ n)) / dn
        u = per_frame(rel0 @ rc.eu) + lam * _dot(xyz, rc.eu)
        v = per_frame(rel0 @ rc.ev) + lam * _dot(xyz, rc.ev)
        hit = ((lam > 0.05) & (lam < zbuf) & (u >= 0) & (u <= rc.su)
               & (v >= 0) & (v <= rc.sv))
        tx = torch.clamp(u * TEXTURE_PPM + rc.tex_off[0], 0, Tw - 1.001)
        ty = torch.clamp(v * TEXTURE_PPM + rc.tex_off[1], 0, Th - 1.001)
        x0 = tx.to(torch.int64)
        y0 = ty.to(torch.int64)
        fx_, fy_ = tx - x0, ty - y0
        i00 = y0 * Tw + x0
        val = (flat[i00] * (1 - fx_) * (1 - fy_) + flat[i00 + 1] * fx_ * (1 - fy_)
               + flat[i00 + Tw] * (1 - fx_) * fy_
               + flat[i00 + Tw + 1] * fx_ * fy_)
        gray = torch.where(hit, val.to(torch.float32).to(f64), gray)
        zbuf = torch.where(hit, lam, zbuf)
    seen = torch.isfinite(zbuf)
    depth = torch.where(seen, zbuf, torch.zeros_like(zbuf)).to(torch.float32)
    # the generator's uint8 RGB, read back as luma: floor of the grey
    luma = torch.where(seen, gray, torch.zeros_like(gray)).to(torch.float32)
    luma = torch.floor(torch.clamp(luma, 0.0, 255.0))
    return luma, depth


def kinect_depth(depth: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Axial Kinect noise, then TUM's 1/5000 m quantisation; 0 stays 0."""
    sigma = 0.0012 + 0.0019 * (depth - 0.4) ** 2
    noise = torch.randn(depth.shape, generator=gen, device=depth.device)
    z = torch.clamp(depth + sigma * noise, min=0.05)
    z = torch.round(z * 5000.0) / 5000.0
    return torch.where(depth > 0, z, torch.zeros_like(depth))


def axis_angle_matrix(aa: np.ndarray) -> np.ndarray:
    """Rodrigues: rotation vectors [..., 3] -> matrices [..., 3, 3]."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa, axis=-1, keepdims=True)
    k = aa / np.where(th > 1e-12, th, 1.0)
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s, c = np.sin(th)[..., None], np.cos(th)[..., None]
    return np.eye(3) + s * K + (1 - c) * (K @ K)


def sweep_path(rng: np.random.Generator, n_frames: int, speed_m_s: float,
               rot_deg_s: float, rate_hz: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """A closed sweep of `n_frames` at a sensor rate, whose last frame
    leads into its first as any other frame into the next, so that it
    plays round and round: a circle at `speed_m_s` (each frame's chord
    `speed_m_s / rate_hz`) in a plane through a random heading near +x,
    tilted from the horizontal, the view turning to and fro about a
    tilted, mostly vertical axis by a sine whose mean rate is `rot_deg_s`.
    -> (R [F, 3, 3], t [F, 3]) camera-to-world, float64."""
    step = speed_m_s / rate_hz
    radius = step / (2.0 * math.sin(math.pi / n_frames))
    amp = math.radians(rot_deg_s / rate_hz) * n_frames / 4.0
    heading = rng.uniform(-0.35, 0.35)
    d = np.array([math.cos(heading), 0.0, math.sin(heading)])
    lean = rng.uniform(-0.5, 0.5)
    e = (math.cos(lean) * np.array([-d[2], 0.0, d[0]])
         + math.sin(lean) * np.array([0.0, 1.0, 0.0]))
    centre = np.array([rng.uniform(-0.6, 0.0), rng.uniform(-0.2, 0.1),
                       rng.uniform(-0.3, 0.1)])
    tilt = rng.uniform(-0.5, 0.5)
    axis = np.array([math.sin(tilt), math.cos(tilt), 0.0])
    phase = rng.uniform(0.0, 2.0 * math.pi)
    R0 = axis_angle_matrix(np.array([-rng.uniform(0.05, 0.3),
                                     rng.uniform(-0.3, 0.3), 0.0]))
    k = np.arange(n_frames, dtype=np.float64)
    phi = 2 * math.pi * k / n_frames
    theta = amp * (np.sin(phi + phase) - math.sin(phase))
    R = R0[None] @ axis_angle_matrix(theta[:, None] * axis[None])
    t = centre[None] + radius * (np.sin(phi)[:, None] * d[None]
                                 + (1.0 - np.cos(phi))[:, None] * e[None])
    return R, t


def render_numpy(cam: Camera, rects: List[Rect], tex: np.ndarray,
                 R: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """A frozen copy of `BoxSceneGenerator.render` (exact luma as the
    uint8 it writes, depth without noise) for one pose, from given
    rectangles and texture."""
    H, W = cam.height, cam.width
    us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    dirs_cam = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                         np.ones_like(us)], axis=-1)
    dirs_world = dirs_cam @ np.asarray(R, np.float64).T
    t = np.asarray(t, np.float64)
    zbuf = np.full((H, W), np.inf)
    gray = np.zeros((H, W), np.float32)
    Th, Tw = tex.shape
    for (o, eu, ev, su, sv, (ox, oy)) in rects:
        n = np.cross(eu, ev)
        dn = dirs_world @ n
        lam = ((o - t) @ n) / np.where(np.abs(dn) < 1e-9, 1e-9, dn)
        pts = t[None, None, :] + lam[..., None] * dirs_world
        rel = pts - o
        u = rel @ eu
        v = rel @ ev
        hit = ((lam > 0.05) & (lam < zbuf)
               & (u >= 0) & (u <= su) & (v >= 0) & (v <= sv))
        tex_x = np.clip(u * TEXTURE_PPM + ox, 0, Tw - 1.001)
        tex_y = np.clip(v * TEXTURE_PPM + oy, 0, Th - 1.001)
        x0 = tex_x.astype(np.int64)
        y0 = tex_y.astype(np.int64)
        fx_ = tex_x - x0
        fy_ = tex_y - y0
        val = (tex[y0, x0] * (1 - fx_) * (1 - fy_)
               + tex[y0, x0 + 1] * fx_ * (1 - fy_)
               + tex[y0 + 1, x0] * (1 - fx_) * fy_
               + tex[y0 + 1, x0 + 1] * fx_ * fy_)
        gray = np.where(hit, val, gray).astype(np.float32)
        zbuf = np.where(hit, lam, zbuf)
    seen = np.isfinite(zbuf)
    depth = np.where(seen, zbuf, 0.0).astype(np.float32)
    luma = np.where(seen, gray, 0.0).astype(np.uint8).astype(np.float32)
    return luma, depth
