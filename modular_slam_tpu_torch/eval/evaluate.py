"""Multi-sequence evaluation (counterpart of
modular_slam_tpu/eval/evaluate.py, flag for flag, plus `--cpu`).

One invocation runs N TUM-format sequences through a chosen pipeline and
writes an artifact directory:

    out/
      <seq>/trajectory.txt      estimated trajectory (TUM format)
      <seq>/trajectory_xyz.png  xyz-over-time plot vs groundtruth
      <seq>/trajectory_topdown.png
      ate.csv                   one row of ATE stats per sequence
      report.json               everything incl. fps + loop closures
                                (+ scaling efficiency with --multiseq)

The plots need matplotlib; without it `report.json` records the
sequence's `plot_error` instead, as the JAX package does.  With
--multiseq the sequences are additionally run *batched* through the
data-parallel step (parallel/multiseq.py) and the report gains the
BASELINE config-5 metric throughput(B sequences batched) / (devices *
throughput(single sequence)); on one card `devices` is 1, so it is the
batched throughput over the single one.

    python -m modular_slam_tpu_torch.eval.evaluate --datasets d1 d2 d3 \\
        --out report_dir [--pipeline slam|full|odometry] [--multiseq] \\
        [--max-frames N] [--cpu]

It runs on the card unless `--cpu` asks for the CPU, and raises with no
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def _run_sequence(cfg, ds, pipeline: str, seed: int,
                  max_frames: Optional[int], disable_loop: bool = False,
                  device="cuda") -> Dict:
    from modular_slam_tpu_torch.models import make_pipeline

    system = make_pipeline(pipeline, cfg, device=device, seed=seed)
    if disable_loop:
        system.enable_loop_closure = False
    t0 = time.perf_counter()
    n = 0
    for i, (rgb, depth, ts) in enumerate(ds.prefetch_iter()):
        if max_frames is not None and i >= max_frames:
            break
        system.process(rgb, depth, ts)
        n += 1
    wall = time.perf_counter() - t0
    # complete deferred work (in-flight BA) before scoring the map
    system.flush_backend()
    traj = system.trajectory
    est = np.zeros((len(traj), 8), np.float64)
    if traj:
        q = torch.stack([p.q for _, p in traj]).cpu().numpy()
        t = torch.stack([p.t for _, p in traj]).cpu().numpy()
        est[:, 0] = [ts for ts, _ in traj]
        est[:, 1:4] = t
        est[:, 4:7] = q[:, 1:4]
        est[:, 7] = q[:, 0]
    return {
        "system": system,
        "est": est,
        # the map trajectory AFTER BA/loop corrections: the live
        # per-frame estimate above cannot improve when a closure lands
        "kf_est": system.keyframe_trajectory(),
        "frames": n,
        "wall_s": wall,
        "fps": n / wall if wall > 0 else 0.0,
    }


def _load_tum_trajectory(path: str) -> np.ndarray:
    """[N, 8] rows `t x y z qx qy qz qw` (comments/headers skipped)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) >= 8:
                rows.append([float(v) for v in parts[:8]])
    if not rows:
        raise ValueError(f"no trajectory rows in {path}")
    return np.asarray(rows, np.float64)


def _comparison_trajectory(spec_path: str, seq_name: str,
                           n_datasets: int) -> Optional[str]:
    """Resolve a --compare path for one sequence: a directory contains
    `<seq>.txt` per sequence; a plain file applies when evaluating a
    single dataset."""
    if os.path.isdir(spec_path):
        cand = os.path.join(spec_path, seq_name + ".txt")
        return cand if os.path.exists(cand) else None
    return spec_path if n_datasets == 1 else None


def evaluate_datasets(dataset_dirs: List[str], out_dir: str,
                      pipeline: str = "slam", seed: int = 0,
                      max_frames: Optional[int] = None,
                      multiseq: bool = False,
                      compare: Optional[Dict[str, str]] = None,
                      ablate_loop: bool = False, device="cuda") -> Dict:
    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.eval.report import (plot_trajectories,
                                                    write_ate_csv)
    from modular_slam_tpu_torch.io.tum import TumRgbdDataset

    os.makedirs(out_dir, exist_ok=True)
    ate_rows: Dict[str, Dict[str, float]] = {}
    report: Dict = {"pipeline": pipeline, "sequences": {}}

    datasets = []
    for d in dataset_dirs:
        name = os.path.basename(os.path.normpath(d))
        ds = TumRgbdDataset(d)
        datasets.append((name, ds))
        cfg = SlamConfig().replace(camera=ds.camera)

        res = _run_sequence(cfg, ds, pipeline, seed, max_frames,
                            device=device)
        seq_dir = os.path.join(out_dir, name)
        os.makedirs(seq_dir, exist_ok=True)

        traj_path = os.path.join(seq_dir, "trajectory.txt")
        with open(traj_path, "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for row in res["est"]:
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")

        seq_report = {
            "frames": res["frames"],
            "fps": round(res["fps"], 2),
            "keyframes": res["system"].n_keyframes,
            "landmarks": res["system"].n_landmarks,
            "loop_closures": res["system"].n_loop_closures,
        }
        if ds.groundtruth is not None:
            try:
                stats = ate_rmse(res["est"], ds.groundtruth,
                                 max_difference=0.05)
                ate_rows[name] = stats
                seq_report["ate_rmse"] = round(stats["rmse"], 5)
            except ValueError as e:
                seq_report["ate_error"] = str(e)
            # the corrected keyframe (map) trajectory side by side
            try:
                kf_stats = ate_rmse(res["kf_est"], ds.groundtruth,
                                    max_difference=0.05)
                ate_rows[f"{name}:keyframes"] = kf_stats
                seq_report["kf_ate_rmse"] = round(kf_stats["rmse"], 5)
            except ValueError as e:
                seq_report["kf_ate_error"] = str(e)
            if ablate_loop and pipeline == "full":
                # the same run with loop closure off: the artifact then
                # carries the closure machinery's value on its sequences
                res_off = _run_sequence(cfg, ds, pipeline, seed,
                                        max_frames, disable_loop=True,
                                        device=device)
                try:
                    seq_report["ate_rmse_loop_off"] = round(ate_rmse(
                        res_off["est"], ds.groundtruth,
                        max_difference=0.05)["rmse"], 5)
                    seq_report["kf_ate_rmse_loop_off"] = round(ate_rmse(
                        res_off["kf_est"], ds.groundtruth,
                        max_difference=0.05)["rmse"], 5)
                except ValueError as e:
                    seq_report["ablate_error"] = str(e)
            # externally produced TUM trajectories (other systems' runs)
            # tabulated against the same groundtruth
            for other, spec in (compare or {}).items():
                path = _comparison_trajectory(spec, name, len(dataset_dirs))
                if path is None:
                    continue
                try:
                    o_stats = ate_rmse(_load_tum_trajectory(path),
                                       ds.groundtruth, max_difference=0.05)
                    ate_rows[f"{name}:{other}"] = o_stats
                    seq_report.setdefault("compare", {})[other] = round(
                        o_stats["rmse"], 5)
                except (OSError, ValueError) as e:
                    seq_report.setdefault("compare_errors", {})[other] = str(e)
            try:
                plot_trajectories(res["est"], ds.groundtruth, seq_dir,
                                  max_difference=0.05)
            except Exception as e:  # matplotlib optional
                seq_report["plot_error"] = str(e)
        report["sequences"][name] = seq_report
        print(f"[{name}] {seq_report}", file=sys.stderr)

    if ate_rows:
        write_ate_csv(os.path.join(out_dir, "ate.csv"), ate_rows)

    if multiseq and len(datasets) >= 2:
        report["multiseq"] = _multiseq_scaling(datasets, max_frames, device)

    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def _multiseq_scaling(datasets, max_frames: Optional[int],
                      device="cuda") -> Dict:
    """Batched run over all sequences vs a single-sequence run: the
    BASELINE config-5 scaling-efficiency metric."""
    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.engine import _resolve_device
    from modular_slam_tpu_torch.parallel.mesh import make_mesh
    from modular_slam_tpu_torch.parallel.multiseq import (
        MultiSequenceRunner, scaling_efficiency)

    dev = _resolve_device(device)
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    # the batched step needs one camera and frame shape for all rows
    cam = datasets[0][1].camera
    cfg = SlamConfig().replace(camera=cam)
    seqs = [list(ds)[:max_frames] if max_frames else list(ds)
            for _, ds in datasets]
    batch = len(seqs)
    n_dev = min(batch, len(devices))

    runner1 = MultiSequenceRunner(
        cfg, batch=1, mesh=make_mesh(seq=1, devices=devices[:1]))
    r1 = runner1.run(seqs[:1], max_frames=max_frames)
    runnerN = MultiSequenceRunner(
        cfg, batch=batch, mesh=make_mesh(seq=n_dev, devices=devices[:n_dev]))
    rN = runnerN.run(seqs, max_frames=max_frames)
    eff = scaling_efficiency(rN["frames_per_s"], r1["frames_per_s"], n_dev)
    return {
        "batch": batch,
        "devices": n_dev,
        "single_seq_fps": round(r1["frames_per_s"], 2),
        "batched_fps": round(rN["frames_per_s"], 2),
        "scaling_efficiency": round(eff, 3),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run + evaluate SLAM over multiple sequences")
    ap.add_argument("--datasets", nargs="+", required=True,
                    help="TUM-format sequence directories")
    ap.add_argument("--out", required=True, help="report output directory")
    ap.add_argument("--pipeline", choices=["odometry", "slam", "full"],
                    default="slam")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--multiseq", action="store_true",
                    help="also measure batched multi-sequence scaling")
    ap.add_argument("--ablate-loop", action="store_true",
                    help="with --pipeline full: also run each sequence "
                         "with loop closure disabled and record "
                         "ate_rmse_loop_off / kf_ate_rmse_loop_off")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="tabulate an externally produced TUM trajectory "
                         "side-by-side (PATH = file, or dir of <seq>.txt); "
                         "repeatable, e.g. --compare orbslam3=runs/orb3")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions); "
                         "default: the CUDA card")
    args = ap.parse_args(argv)

    compare = {}
    for spec in args.compare:
        if "=" not in spec:
            ap.error(f"--compare wants NAME=PATH, got {spec!r}")
        k, v = spec.split("=", 1)
        compare[k] = v

    report = evaluate_datasets(
        args.datasets, args.out, pipeline=args.pipeline, seed=args.seed,
        max_frames=args.max_frames, multiseq=args.multiseq,
        compare=compare or None, ablate_loop=args.ablate_loop,
        device="cpu" if args.cpu else "cuda")
    print(json.dumps(report, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
