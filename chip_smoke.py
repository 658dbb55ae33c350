#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`modular_slam_tpu_torch`).

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build       nvcc-builds both CUDA kernels from modular_slam_tpu_torch/csrc
  K1          FAST score kernel vs its plain PyTorch version on the 8 pyramid
              levels of a 640x480 frame and on a batch of 4 frames: exact
  K2          Hamming 2-NN kernel (+ tile merge) vs the plain matcher at
              Nq=512, L=16384: exact
  odometry    the odometry preset, SlamSystem(SlamConfig(), device="cuda"),
              over 48 rendered 640x480 frames: every frame tracked, ATE
              < 0.01 m, and the launch counts prove the path ran the kernels
  cpu_vs_gpu  the same 8 frames through the port on "cpu" (plain versions)
              and on "cuda" (kernels) with equally seeded samplers
  profile     per-stage host and device time, device busy time, idle
              share and top device ops per frame
  kernels     every ported kernel: launches on the odometry path, error,
              kernel and plain-version device times

then the card's name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no last
line; it also exits non-zero when no CUDA device is present.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

N_FRAMES = 48          # odometry phase
N_CMP_FRAMES = 8       # cpu_vs_gpu phase
STEP_T = (0.015, 0.005, -0.004)   # mixed translation + rotation steps
STEP_ROT = (0.002, 0.006, 0.004)
ATE_BOUND_M = 0.01
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3
TIMED_RUNS = 25
LEVEL_SHAPES = [(480, 640), (400, 533), (333, 444), (278, 370),
                (231, 309), (193, 257), (161, 214), (134, 179)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def median_ms(torch, fn, runs: int = TIMED_RUNS) -> float:
    """Median wall time of one call of fn, timed with CUDA events around
    each call: for a small kernel this is bounded by the host's launch
    overhead, not by the device."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", None)
                 or getattr(event, "self_cuda_time_total", 0.0))


def device_ms(torch, fn, runs: int = TIMED_RUNS, name: str = "") -> float:
    """Device time of one call of fn: the sum of its kernels' times in a
    torch.profiler trace of `runs` calls (only kernels whose name holds
    `name`, when given), divided by `runs`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages()
                if name in e.key)
    return total / runs / 1e3


def timings(torch, fn, name: str = "") -> dict:
    return {"device_ms": device_ms(torch, fn, name=name),
            "wall_ms": median_ms(torch, fn)}


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    kernels.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(kernels.KERNELS)})


def phase_k1(torch, frames, cfg) -> dict:
    from modular_slam_tpu_torch.io.tum import rgb_to_luma
    from modular_slam_tpu_torch.ops.fast import (fast_score_cuda,
                                                 fast_score_plain)
    from modular_slam_tpu_torch.ops.pyramid import build_pyramid

    grays = [rgb_to_luma(torch.as_tensor(rgb, device="cuda"))
             for rgb, _, _ in frames[:4]]
    levels = build_pyramid(grays[0], cfg.detector)
    check([tuple(x.shape) for x in levels] == LEVEL_SHAPES,
          f"K1: pyramid shapes {[tuple(x.shape) for x in levels]}")
    rows, max_err = [], 0.0
    for img in levels + [torch.stack(grays)]:
        got = fast_score_cuda(img)
        ref = fast_score_plain(img)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        inner = (got[..., 3:-3, 3:-3] != ref[..., 3:-3, 3:-3]).sum().item()
        check(inner == 0, f"K1: {inner} scores differ inside the 3-px "
                          f"border at {tuple(img.shape)}")
        max_err = max(max_err, err)
        rows.append({"shape": list(img.shape),
                     "mismatch": int((got != ref).sum()),
                     "mismatch_inside_3px": inner,
                     "kernel": timings(torch, lambda: fast_score_cuda(img)),
                     "plain": timings(torch, lambda: fast_score_plain(img))})
    per_frame = {
        "ms": sum(r["kernel"]["device_ms"] for r in rows[:8]),
        "plain_ms": sum(r["plain"]["device_ms"] for r in rows[:8]),
        "wall_ms": sum(r["kernel"]["wall_ms"] for r in rows[:8]),
        "plain_wall_ms": sum(r["plain"]["wall_ms"] for r in rows[:8])}
    emit({"phase": "K1", "tolerance": "exact inside a 3-px border",
          "max_abs_err": max_err, "per_frame_8_levels":
          per_frame, "shapes": rows})
    return {"max_abs_err": max_err, **per_frame}


def phase_k2(torch, cfg) -> dict:
    from modular_slam_tpu_torch.ops.match import (hamming_2nn_tiles,
                                                  match_descriptors,
                                                  match_descriptors_plain)

    g = torch.Generator().manual_seed(0)
    Nq, L = cfg.detector.max_keypoints, cfg.map.max_landmarks
    q = (torch.randint(0, 2, (Nq, 256), generator=g) * 2 - 1).to(torch.int8)
    t = (torch.randint(0, 2, (L, 256), generator=g) * 2 - 1).to(torch.int8)
    # planted near-duplicates (up to 8 flipped bits) so that real matches
    # survive the ratio test
    rows = torch.randperm(L, generator=g)[:Nq // 2]
    t[rows] = q[:Nq // 2]
    flips = torch.randint(0, 256, (Nq // 2, 8), generator=g)
    t[rows[:, None], flips] *= -1
    qv = torch.rand(Nq, generator=g) > 0.05
    tv = torch.rand(L, generator=g) > 0.10      # ~10 % invalid rows
    q, t, qv, tv = (x.cuda() for x in (q, t, qv, tv))

    mk = match_descriptors(q, qv, t, tv, cfg.matcher)
    mp = match_descriptors_plain(q, qv, t, tv, cfg.matcher)
    torch.cuda.synchronize()
    v = mp.valid
    check(torch.equal(mk.valid, mp.valid), "K2: valid masks differ")
    check(torch.equal(mk.lm_slot[v], mp.lm_slot[v]), "K2: lm_slot differs")
    check(torch.equal(mk.distance[v], mp.distance[v]), "K2: distance differs")
    n_valid = int(v.sum())
    check(n_valid >= Nq // 4, f"K2: only {n_valid} matches survive")
    max_err = float((mk.distance[v] - mp.distance[v]).abs().max())
    kern = timings(torch, lambda: match_descriptors(q, qv, t, tv, cfg.matcher))
    kern["kernel_only_device_ms"] = device_ms(
        torch, lambda: hamming_2nn_tiles(q, t, tv), name="hamming_2nn")
    plain = timings(torch, lambda: match_descriptors_plain(
        q, qv, t, tv, cfg.matcher))
    emit({"phase": "K2", "tolerance": "exact", "Nq": Nq, "L": L,
          "valid_matches": n_valid,
          "invalid_rows": int((~tv).sum()), "max_abs_err": max_err,
          "kernel_plus_merge": kern, "plain": plain})
    return {"max_abs_err": max_err, "ms": kern["device_ms"],
            "plain_ms": plain["device_ms"]}


def _gt_array(poses):
    import numpy as np

    return np.array([[k / 30.0, *p.t, *p.q[1:], p.q[0]]
                     for k, p in enumerate(poses)], np.float64)


def phase_odometry(torch, kernels, frames, poses, cfg) -> dict:
    import numpy as np

    from modular_slam_tpu_torch.engine import SlamResult, SlamSystem
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.io.trajectory import trajectory_array

    system = SlamSystem(cfg, device="cuda", seed=0)
    kernels.reset_launch_counts()
    codes, wall = [], []
    for rgb, depth, ts in frames:
        t0 = time.perf_counter()
        codes.append(system.process(rgb, depth, ts))
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    launches = kernels.launch_counts()

    n = len(frames)
    bad = [k for k, c in enumerate(codes) if c != SlamResult.SUCCESS]
    check(not bad, f"odometry: frames {bad} not SUCCESS")
    est = trajectory_array(system.trajectory)
    check(est.shape == (n, 8) and np.isfinite(est).all(),
          "odometry: trajectory not finite or of the wrong shape")
    feats = system.last_features
    check(tuple(feats.keypoints.uv.shape) == (cfg.detector.max_keypoints, 2)
          and tuple(feats.descriptors.unpacked.shape)
          == (cfg.detector.max_keypoints, 256), "odometry: feature shapes")
    ate = ate_rmse(est, _gt_array(poses))["rmse"]
    check(ate < ATE_BOUND_M, f"odometry: ATE {ate} m >= {ATE_BOUND_M} m")
    k1_want = cfg.detector.n_levels * n
    check(launches["fast_score"] == k1_want,
          f"odometry: fast_score launched {launches['fast_score']} times, "
          f"expected {k1_want}")
    check(launches["hamming_2nn"] == n - 1,
          f"odometry: hamming_2nn launched {launches['hamming_2nn']} times, "
          f"expected {n - 1}")
    warm = wall[8:]
    emit({"phase": "odometry", "frames": n, "all_success": True,
          "ate_rmse_m": ate, "keyframes": system.n_keyframes,
          "landmarks": system.n_landmarks, "launches": launches,
          "frames_per_s": len(warm) / sum(warm),
          "ms_per_frame": 1e3 * sum(warm) / len(warm),
          "ms_per_frame_median": 1e3 * statistics.median(warm),
          "first_frame_ms": 1e3 * wall[0]})
    return launches, 1e3 * sum(warm) / len(warm)


def _rot_angle(q1, q2) -> float:
    """Angle between two unit quaternions, 4 asin(|q1 - q2| / 2) with the
    signs aligned: well conditioned for small angles, where acos of the
    dot product loses half the digits."""
    if float((q1 * q2).sum()) < 0:
        q2 = -q2
    return 4.0 * math.asin(min(1.0, float((q1 - q2).norm()) / 2.0))


def phase_cpu_vs_gpu(torch, frames, cfg) -> None:
    from modular_slam_tpu_torch.engine import SlamSystem
    from modular_slam_tpu_torch.ops.pnp import MultinomialSampler

    runs = {}
    for dev in ("cpu", "cuda"):
        system = SlamSystem(cfg, device=dev, sampler=MultinomialSampler(0))
        for f in frames:
            system.process(*f)
        runs[dev] = [(bool(r.tracking_ok), bool(r.new_keyframe),
                      int(r.n_matches), int(r.n_inliers),
                      r.pose.q.cpu().double(), r.pose.t.cpu().double())
                     for r in system.results]
    dt, dr, same_counts = 0.0, 0.0, 0
    for k, (c, g) in enumerate(zip(runs["cpu"], runs["cuda"])):
        check(c[:2] == g[:2], f"cpu_vs_gpu: frame {k} tracking_ok/"
                              f"new_keyframe {c[:2]} vs {g[:2]}")
        dt = max(dt, float((c[5] - g[5]).abs().max()))
        dr = max(dr, _rot_angle(c[4], g[4]))
        same_counts += c[2:4] == g[2:4]
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_RAD,
          f"cpu_vs_gpu: pose difference {dt} m / {dr} rad")
    emit({"phase": "cpu_vs_gpu", "frames": len(frames),
          "flags_equal": True, "max_dt_m": dt, "max_drot_rad": dr,
          "tol_m": POSE_TOL_M, "tol_rad": POSE_TOL_RAD,
          "frames_with_equal_match_and_inlier_counts": same_counts})


def phase_profile(torch, frames, cfg, ms_per_frame: float) -> None:
    """Where a frame's time goes, on a fresh system outside the counted
    run, after 4 warm-up frames, over two windows of 8 frames:

    A. the engine step cut into its stages (upload, detect, track), each
       ended by a device synchronize: host ms per stage;
    B. whole `process` calls under a CUDA-only trace: device busy ms and
       device ops per frame, the idle share against the unprofiled
       ms/frame of the odometry phase, and the top device ops."""
    from torch.profiler import ProfilerActivity, profile

    from modular_slam_tpu_torch.engine import SlamSystem
    from modular_slam_tpu_torch.frontend.tracker import track_frame
    from modular_slam_tpu_torch.io.tum import frame_to_device
    from modular_slam_tpu_torch.ops.detector import detect

    n = 8
    system = SlamSystem(cfg, device="cuda", seed=0)
    for f in frames[:4]:
        system.process(*f)
    wall = {"upload": 0.0, "detect": 0.0, "track": 0.0}

    def timed(stage, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[stage] += time.perf_counter() - t0
        return out

    for rgb, depth, ts in frames[4:4 + n]:
        fr = timed("upload", lambda: frame_to_device(rgb, depth, ts, "cuda"))
        feats = timed("detect",
                      lambda: detect(fr.gray, fr.depth, cfg.detector))
        system.arena, system.state, _ = timed("track", lambda: track_frame(
            system.arena, system.state, feats, system.cam, cfg, fr.timestamp,
            system.sampler))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for f in frames[4 + n:4 + 2 * n]:
            system.process(*f)
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=_device_us, reverse=True)
    busy_ms = sum(_device_us(e) for e in events) / n / 1e3
    emit({"phase": "profile", "frames_per_window": n,
          "stage_host_ms_per_frame": {k: 1e3 * v / n
                                      for k, v in wall.items()},
          "device_busy_ms_per_frame": busy_ms,
          "device_ops_per_frame": sum(e.count for e in events) / n,
          "unprofiled_ms_per_frame": ms_per_frame,
          "device_idle_share": 1.0 - busy_ms / ms_per_frame,
          "top_device_ops": [
              {"name": e.key[:120], "calls_per_frame": e.count / n,
               "ms_per_frame": _device_us(e) / n / 1e3}
              for e in events[:12]]})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "one", file=sys.stderr)
        return 2

    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.ops import kernels

    torch.cuda.set_device(0)
    cfg = SlamConfig()
    gen = PlaneSceneGenerator(cfg.camera, seed=0)
    poses = gen.trajectory(N_FRAMES, step_t=STEP_T, step_rot=STEP_ROT)
    frames = list(gen.sequence(poses))

    phase_build(kernels)
    k1 = phase_k1(torch, frames, cfg)
    k2 = phase_k2(torch, cfg)
    launches, ms_per_frame = phase_odometry(torch, kernels, frames, poses,
                                            cfg)
    phase_cpu_vs_gpu(torch, frames[:N_CMP_FRAMES], cfg)
    phase_profile(torch, frames, cfg, ms_per_frame)

    timing = {"fast_score": k1, "hamming_2nn": k2}
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source_relpath,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": timing[k.name]["max_abs_err"],
         "ms": timing[k.name]["ms"], "plain_ms": timing[k.name]["plain_ms"]}
        for k in kernels.KERNELS.values()]})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
