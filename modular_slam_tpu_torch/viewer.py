"""Viewer app — the reference's Qt6 Viewer (src/app/viewer/viewer.cpp)
rebuilt headless + web (counterpart of modular_slam_tpu/viewer.py, flag
for flag; `--cpu` runs on the CPU, otherwise the card, and it raises
with no card).

    python -m modular_slam_tpu_torch.viewer --dataset /path/to/tum_seq \
        [--serve PORT] [--save-dir DIR] [--out traj.txt --format tum|kitti] \
        [--scene-every K] [--max-frames N] [--fps-limit F] [--cpu]

(`mslam-torch-viewer` once installed.)  The scene snapshot needs
matplotlib (`--save-dir` or `--serve` render one at frame 0).

What the reference viewer does and where it lives here:
- RGB view with observation overlay (image_viewer.cpp:27-58)
  -> viz/overlay.py, published per frame / saved to --save-dir
- HOT-colormapped depth (depth_image_viewer.cpp:9-44)
  -> viz.overlay.depth_colormap
- OpenGL point-cloud + landmark + keyframe-frustum scene
  (pointcloud_viewer.cpp) -> viz.scene.render_scene snapshots every
  --scene-every frames (+ PLY export at exit)
- live stats ms/frame, FPS, counts (slam_statistics_widget.cpp:28-34)
  -> /stats.json + final stderr report; unlike the reference (bug #15:
  stats emitted from the previous frame's visit) these are current-frame
- parameter widgets with write-back (parameters_viewer.cpp:71-83; the
  reference's setValue is a stub :53-62) -> /params GET/POST, applied live
- pause/resume/interrupt atomics (slam_thread.hpp:43-45,63-64)
  -> /control POST
- KITTI/TUM trajectory dumpers as frame-finished actions
  (viewer.cpp:105-164,206-228) -> --out/--format via frame observer
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time as _time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="SLAM viewer (PyTorch/CUDA)")
    ap.add_argument("--dataset", required=True, help="TUM-format sequence dir")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the live web viewer on this port")
    ap.add_argument("--save-dir", default=None,
                    help="save overlay/depth/scene PNGs here")
    ap.add_argument("--save-every", type=int, default=10,
                    help="save PNGs every K frames (with --save-dir)")
    ap.add_argument("--scene-every", type=int, default=30,
                    help="re-render the 3D scene every K frames")
    ap.add_argument("--out", default=None, help="trajectory output path")
    ap.add_argument("--format", choices=["tum", "kitti"], default="tum")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--pipeline", choices=["odometry", "slam", "full"],
                    default="slam")
    ap.add_argument("--fps-limit", type=float, default=None,
                    help="throttle processing (playback-style viewing)")
    ap.add_argument("--ply", default=None, help="export final map as PLY")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.io import (
        KittiTrajectoryWriter, TumRgbdDataset, TumTrajectoryWriter,
    )
    from modular_slam_tpu_torch.models import make_pipeline
    from modular_slam_tpu_torch.viz.overlay import (
        depth_colormap, draw_observations, make_overlay_fn,
    )
    from modular_slam_tpu_torch.viz.png import write_png
    from modular_slam_tpu_torch.viz.scene import (pointcloud_from_rgbd,
                                                  render_scene)

    device = "cpu" if args.cpu else "cuda"
    cfg = SlamConfig()
    ds = TumRgbdDataset(args.dataset, cfg.camera)
    print(f"dataset: {len(ds)} frames", file=sys.stderr)

    system = make_pipeline(args.pipeline, cfg, device=device,
                           seed=args.seed)
    overlay_fn = make_overlay_fn(system.cfg, device)

    server = None
    if args.serve is not None:
        from modular_slam_tpu_torch.viz.server import ViewerServer

        server = ViewerServer(port=args.serve).start()
        server.state.params = system.params
        print(f"live viewer: {server.url}", file=sys.stderr)

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    writer = None
    if args.out:
        writer = (TumTrajectoryWriter(args.out) if args.format == "tum"
                  else KittiTrajectoryWriter(args.out))

    times_ms = []
    scene_png_path = os.path.join(args.save_dir or tempfile.gettempdir(),
                                  "scene.png")
    n_processed = 0
    try:
        for i, (rgb, depth, ts) in enumerate(ds.prefetch_iter()):
            if args.max_frames is not None and i >= args.max_frames:
                break
            if server is not None and not server.state.wait_if_paused():
                print("stopped from viewer", file=sys.stderr)
                break

            t0 = _time.perf_counter()
            system.process(rgb, depth, ts)
            dt_ms = (_time.perf_counter() - t0) * 1e3
            times_ms.append(dt_ms)
            n_processed += 1
            if writer is not None:
                writer.write(ts, system.trajectory[-1][1])

            want_view = (
                server is not None
                or (args.save_dir and i % args.save_every == 0)
            )
            if want_view:
                od = overlay_fn(system.arena, system.state,
                                system.last_features)
                over = draw_observations(
                    rgb, od.kp_uv.cpu().numpy(), od.lm_uv.cpu().numpy(),
                    od.valid.cpu().numpy())
                dvis = depth_colormap(depth)
                stats = system.stats()
                stats["ms_per_frame"] = round(dt_ms, 2)
                stats["fps"] = round(1e3 / max(dt_ms, 1e-6), 1)
                stats["frame"] = i
                if server is not None:
                    server.state.publish_frame(over)
                    server.state.publish_depth(dvis)
                    server.state.publish_stats(stats)
                if args.save_dir and i % args.save_every == 0:
                    write_png(os.path.join(
                        args.save_dir, f"frame_{i:06d}.png"), over)
                    write_png(os.path.join(
                        args.save_dir, f"depth_{i:06d}.png"), dvis)

            if i % args.scene_every == 0 and (server or args.save_dir):
                traj = torch.stack(
                    [p.t for _, p in system.trajectory]).cpu().numpy()
                cloud = pointcloud_from_rgbd(
                    rgb, depth, system.cfg.camera,
                    system.state.pose.q.cpu().numpy(),
                    system.state.pose.t.cpu().numpy(), stride=6)
                render_scene(scene_png_path, system.arena, traj, cloud,
                             system.cfg.camera)
                if server is not None:
                    with open(scene_png_path, "rb") as f:
                        server.state.publish_scene_png(f.read())

            if args.fps_limit:
                budget = 1.0 / args.fps_limit
                spent = _time.perf_counter() - t0
                if spent < budget:
                    _time.sleep(budget - spent)
    finally:
        if writer is not None:
            writer.close()

    if args.ply:
        from modular_slam_tpu_torch.eval.ply import export_map_ply

        n = export_map_ply(args.ply, system.arena)
        print(f"map PLY: {args.ply} ({n} elements)", file=sys.stderr)

    stats = system.stats()
    if times_ms:
        arr = np.asarray(times_ms[3:] or times_ms)
        stats["mean_ms_per_frame"] = round(float(arr.mean()), 2)
        stats["fps"] = round(1e3 / max(float(arr.mean()), 1e-6), 1)
    stats["frames"] = n_processed
    print(stats, file=sys.stderr)

    if server is not None:
        print("viewer still serving; ctrl-c to exit", file=sys.stderr)
        try:
            while not server.state.stopped.is_set():
                _time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
