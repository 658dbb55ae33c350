"""Write a synthetic TUM-format RGB-D dataset to disk (counterpart of
modular_slam_tpu/eval/make_dataset.py, numpy-only).

Renders a `PlaneSceneGenerator` trajectory into the on-disk layout
`io/tum.TumRgbdDataset` reads: rgb/ and depth/ PNGs, the rgb.txt and
depth.txt association lists, groundtruth.txt, and an intrinsics.txt that
the reader picks up, so cameras other than the TUM preset round-trip.
Depth is stored as uint16 with the TUM 1/5000 m factor.  For the same
arguments the files are byte-equal to the JAX package's.

    python -m modular_slam_tpu_torch.eval.make_dataset out_dir \\
        --frames 48 [--line] [--laps 2] [--size 320x240] \\
        [--depth-noise 0.01] [--radius 1.2] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from modular_slam_tpu_torch.config import CameraConfig
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.viz.png import write_png

DEPTH_FACTOR = 1.0 / 5000.0  # TUM convention


def write_dataset(out_dir: str, frames: int, loop: bool = True,
                  laps: int = 2, width: int = 320, height: int = 240,
                  depth_noise: float = 0.0, seed: int = 0,
                  radius: float = 1.2) -> dict:
    """`frames` per lap of a `radius` circle, `laps` times (`loop`), or
    `frames` of a straight drift; -> {"frames", "out", "camera", "loop"}."""
    cam = CameraConfig(
        fx=width * 1.0, fy=width * 1.0, cx=width / 2 - 0.5,
        cy=height / 2 - 0.5, width=width, height=height,
        depth_factor=DEPTH_FACTOR)
    gen = PlaneSceneGenerator(cam, seed=seed, depth_noise=depth_noise)
    if loop:
        poses = gen.loop_trajectory(frames, radius=radius) * laps
    else:
        poses = gen.trajectory(frames, step_t=(0.015, 0.006, 0.002),
                               step_rot=(0.001, 0.002, 0.001))

    rgb_dir = os.path.join(out_dir, "rgb")
    depth_dir = os.path.join(out_dir, "depth")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)

    rgb_lines, depth_lines, gt_lines = [], [], []
    for k, (rgb, depth, ts) in enumerate(gen.sequence(poses)):
        name = f"{ts:.6f}.png"
        write_png(os.path.join(rgb_dir, name), rgb)
        d16 = np.clip(np.round(depth / DEPTH_FACTOR), 0, 65535).astype(
            np.uint16)
        write_png(os.path.join(depth_dir, name), d16)
        rgb_lines.append(f"{ts:.6f} rgb/{name}")
        depth_lines.append(f"{ts:.6f} depth/{name}")
        q, t = poses[k].q, poses[k].t    # q wxyz
        gt_lines.append(
            f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}")

    def write_list(name: str, header: str, lines) -> None:
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(f"# {header}\n")
            f.write("\n".join(lines) + "\n")

    write_list("rgb.txt", "timestamp filename", rgb_lines)
    write_list("depth.txt", "timestamp filename", depth_lines)
    write_list("groundtruth.txt", "timestamp tx ty tz qx qy qz qw", gt_lines)
    with open(os.path.join(out_dir, "intrinsics.txt"), "w") as f:
        f.write("# fx fy cx cy depth_factor width height\n")
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} "
                f"{cam.depth_factor} {cam.width} {cam.height}\n")
    return {"frames": len(poses), "out": out_dir, "camera": cam,
            "loop": loop}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="generate a synthetic TUM-format RGB-D sequence")
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=48,
                    help="frames per lap (loop) or total (line)")
    ap.add_argument("--line", action="store_true",
                    help="straight drift trajectory instead of a loop")
    ap.add_argument("--laps", type=int, default=2)
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--depth-noise", type=float, default=0.0)
    ap.add_argument("--radius", type=float, default=1.2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.lower().split("x"))
    info = write_dataset(
        args.out_dir, args.frames, loop=not args.line, laps=args.laps,
        width=w, height=h, depth_noise=args.depth_noise, seed=args.seed,
        radius=args.radius)
    print(f"wrote {info['frames']} frames to {info['out']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
