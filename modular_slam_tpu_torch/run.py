"""Command-line runner (counterpart of modular_slam_tpu/run.py): run SLAM
over a TUM-format dataset, stream the trajectory to disk, print a one-line
JSON report, and exit when the dataset ends.

    python -m modular_slam_tpu_torch.run --dataset /path/to/tum_seq \\
        --out traj.txt [--format tum|kitti] [--pipeline odometry|slam|full] \\
        [--chunk 16] [--ate] [--ply map.ply] [--save-checkpoint ck.npz] \\
        [--load-checkpoint ck.npz] [--set loop.min_score=0.05] [--cpu]

The system runs on the CUDA card; `--cpu` runs it on the CPU (the
kernels' plain versions).  Without `--cpu` and without a card it raises
instead of carrying on on the CPU.

The default `--chunk 16` takes the chunked path in the wire format
(8-bit luma and raw 16-bit depth, `TumRgbdDataset.wire_iter` into
`SlamSystem.process_chunk_wire`) with the deferred host sync; a final
partial chunk runs frame by frame.  `--chunk 1` runs every frame through
`SlamSystem.process`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def apply_overrides(cfg, overrides):
    """Apply `section.field=value` strings to a SlamConfig, casting each
    value to the type of the field's current value."""
    for ov in overrides:
        try:
            dotted, value = ov.split("=", 1)
            section, field = dotted.split(".", 1)
        except ValueError:
            raise SystemExit(f"--set expects section.field=value, got {ov!r}")
        sub = getattr(cfg, section, None)
        if sub is None or not dataclasses.is_dataclass(sub):
            raise SystemExit(f"unknown config section {section!r}")
        if field not in {f.name for f in dataclasses.fields(sub)}:
            raise SystemExit(f"unknown field {dotted!r}")
        current = getattr(sub, field)
        if isinstance(current, bool):
            cast = value.lower() in ("1", "true", "yes", "on")
        else:
            cast = type(current)(value)
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{field: cast})})
    return cfg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="RGB-D SLAM runner (PyTorch)")
    ap.add_argument("--dataset", required=True, help="TUM-format sequence dir")
    ap.add_argument("--out", default=None, help="trajectory output path")
    ap.add_argument("--format", choices=["tum", "kitti"], default="tum")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--pipeline", choices=["odometry", "slam", "full"],
                    default="slam")
    ap.add_argument("--no-ba", action="store_true",
                    help="disable backend BA (same as --pipeline odometry)")
    ap.add_argument("--ate", action="store_true",
                    help="report ATE vs groundtruth.txt")
    ap.add_argument("--ply", default=None, help="export final map as PLY")
    ap.add_argument("--save-checkpoint", default=None)
    ap.add_argument("--load-checkpoint", default=None)
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable the native decode-ahead loader")
    ap.add_argument("--ba-mode", choices=["sync", "async"], default="sync",
                    help="local-BA executor mode; 'async' solves on the "
                         "CPU and merges at the next keyframe")
    ap.add_argument("--chunk", type=int, default=16,
                    help="frames per chunk (default 16: the chunked path, "
                         "one results fetch per chunk, deferred by one "
                         "chunk). With chunking, keyframe BA, loop "
                         "closures and boundary relocalization land at "
                         "chunk boundaries; --chunk 1 runs every frame "
                         "through process(); a final partial chunk runs "
                         "frame by frame")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--detector", default="orb_grid",
                    help="registry detector name")
    ap.add_argument("--matcher", default="hamming_2nn",
                    help="registry matcher name")
    ap.add_argument("--pnp", default="ransac_3p", help="registry pnp name")
    ap.add_argument("--set", action="append", default=[], metavar="S.F=V",
                    help="config override, e.g. --set loop.min_score=0.05 "
                         "(repeatable; cast to the field's type)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.io import (KittiTrajectoryWriter,
                                           TumRgbdDataset,
                                           TumTrajectoryWriter)
    from modular_slam_tpu_torch.models import make_pipeline

    ds = TumRgbdDataset(args.dataset)
    print(f"dataset: {len(ds)} frames", file=sys.stderr)

    pipeline = "odometry" if args.no_ba else args.pipeline
    cfg = apply_overrides(SlamConfig().replace(camera=ds.camera), args.set)
    system = make_pipeline(
        pipeline, cfg, device="cpu" if args.cpu else "cuda", seed=args.seed,
        component_names={"detector": args.detector, "matcher": args.matcher,
                         "pnp": args.pnp},
        ba_mode=args.ba_mode,
        # chunked runs pipeline the host sync: chunk N's bookkeeping runs
        # while the device tracks chunk N+1
        defer_chunk_sync=args.chunk > 1)
    if args.load_checkpoint:
        from modular_slam_tpu_torch.utils.checkpoint import load_checkpoint

        load_checkpoint(args.load_checkpoint, system)
        print(f"resumed from {args.load_checkpoint}", file=sys.stderr)

    writer = None
    if args.out:
        cls = (TumTrajectoryWriter if args.format == "tum"
               else KittiTrajectoryWriter)
        writer = cls(args.out)

    # chunked runs stream the wire format (uint8 luma + raw uint16 depth);
    # per-frame runs keep the rgb frames that process() takes
    use_wire = args.chunk > 1
    if use_wire:
        frames_iter = ds.wire_iter(native_ok=not args.no_prefetch)
    else:
        frames_iter = iter(ds) if args.no_prefetch else ds.prefetch_iter()
    buf = []
    written = 0

    def drain_writer():
        # a cursor: deferred chunks deliver their rows one chunk late
        nonlocal written
        if writer is None:
            return
        while written < len(system.trajectory):
            writer.write(*system.trajectory[written])
            written += 1

    def flush():
        if len(buf) == args.chunk:
            if use_wire:
                system.process_chunk_wire(*zip(*buf))
            else:
                system.process_chunk(*zip(*buf))
        else:
            for r, d, t in buf:
                if use_wire:
                    # the partial tail in wire format: luma replicated to
                    # 3 channels, raw depth to meters
                    rgb3 = np.repeat(r[..., None], 3, axis=-1)
                    system.process(
                        rgb3, d.astype(np.float32) * ds.camera.depth_factor,
                        t)
                else:
                    system.process(r, d, t)
        drain_writer()
        buf.clear()

    t0 = time.perf_counter()
    for i, (rgb, depth, ts) in enumerate(frames_iter):
        if args.max_frames is not None and i >= args.max_frames:
            break
        if args.chunk <= 1:
            system.process(rgb, depth, ts)
            drain_writer()
        else:
            buf.append((rgb, depth, ts))
            if len(buf) == args.chunk:
                flush()
        if (i + 1) % 50 == 0:
            st = system.stats()
            print(f"[{i + 1}] kf={st['keyframes']} lm={st['landmarks']} "
                  f"inl={st['last_n_inliers']}", file=sys.stderr)
    if buf:
        flush()
    system.flush_backend()   # delivers the deferred last chunk
    drain_writer()
    elapsed = time.perf_counter() - t0
    n_ok = sum(1 for r in system.results if bool(r.tracking_ok))
    if writer is not None:
        writer.close()

    n = len(system.trajectory)
    stats = system.stats()
    report = {
        "frames": n,
        "tracked_ok": n_ok,
        "keyframes": stats["keyframes"],
        "landmarks": stats["landmarks"],
        "loop_closures": system.n_loop_closures,
        "relocalizations": system.n_relocalizations,
        "fps": n / elapsed if elapsed > 0 else 0.0,
        "wall_s": elapsed,
    }

    if args.ply:
        from modular_slam_tpu_torch.eval.ply import export_map_ply

        report["ply_points"] = export_map_ply(args.ply, system.arena)
    if args.save_checkpoint:
        from modular_slam_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(args.save_checkpoint, system)

    if (args.ate and ds.groundtruth is not None and args.out
            and args.format == "tum"):
        from modular_slam_tpu_torch.eval.ate import ate_rmse
        from modular_slam_tpu_torch.io import read_tum_trajectory

        est = read_tum_trajectory(args.out)
        try:
            report["ate"] = ate_rmse(est, ds.groundtruth)
        except ValueError as e:
            report["ate_error"] = str(e)

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
