#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`modular_slam_tpu_torch`).

Run from the root of the repository, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

  build       nvcc-builds the three CUDA kernels from
              modular_slam_tpu_torch/csrc, one nvcc per source, together
  K1          FAST score kernel, one launch for all 8 pyramid levels of a
              640x480 frame and for those of a batch of 4 frames, vs its
              plain PyTorch version level by level: exact
  K2          Hamming 2-NN kernel + merge kernel (2 launches) vs the plain
              matcher, and the kernel's split triples vs their plain
              version, at Nq=512, L=16384 and at a ragged Nq=500, L=16000
              with a batch of 2 and a shared landmark operand: exact
  odometry    the odometry preset, SlamSystem(SlamConfig(), device="cuda",
              enable_backend=False), over 48 rendered 640x480 frames: every
              frame tracked, ATE < 0.01 m, and the launch counts prove the
              path ran the kernels (K1 once per frame: 48; K2 and its merge
              once per tracked frame: 47 each)
  cpu_vs_gpu  the same 8 frames through the odometry preset on "cpu" (plain
              versions) and on "cuda" (kernels) with equally seeded samplers
  profile     per-stage host and device time, device busy time, idle
              share and top device ops per odometry frame
  slam        the slam preset, make_pipeline("slam", SlamConfig(),
              device="cuda"): local BA after every keyframe, over the same
              48 frames: every frame tracked, per-frame and keyframe ATE
              < 0.01 m, launches 48 / 47 / 47, one BA call per keyframe;
              ms/frame, ms per BA call and the window sizes
  slam_fast_motion  the slam phase on 48 frames of the same scene at 3x
              the motion per frame (the 48 frames above insert only 2
              keyframes, so local BA runs twice there)
  slam_async  the slam phase's run with ba_mode="async" (solve on the CPU,
              merge at the next keyframe): every frame tracked, ATE, every
              window merged; slam_async_fast_motion the same on the 3x
              motion frames
  ba_cpu_vs_gpu  the last keyframe's window of the slam_fast_motion run
              solved on "cpu" and on "cuda", and the compact global BA of
              its map on both
  ba_profile  one local-BA call and one compact global-BA call of that
              map under a CUDA trace: device busy ms, device ops, host
              syncs and where they happen, LM iterations, top device ops
  kernels     every kernel: launches on the odometry path, error, kernel
              and plain-version device times, the bound (bytes or
              operations at the H100's published peaks), the share of it
              reached, and the library call's time where one exists

then the card's name and power limit, and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no last
line; it also exits non-zero when no CUDA device is present.  Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time

N_FRAMES = 48          # odometry phase
N_CMP_FRAMES = 8       # cpu_vs_gpu phase
STEP_T = (0.015, 0.005, -0.004)   # mixed translation + rotation steps
STEP_ROT = (0.002, 0.006, 0.004)
# slam_fast_motion: the same scene at 3x the motion per frame, where the
# keyframe policy inserts ~8 keyframes in 48 frames instead of 2
FAST_MOTION = 3.0
ATE_BOUND_M = 0.01
POSE_TOL_M = 1e-3
POSE_TOL_RAD = 1e-3
BA_POSE_TOL_M = 1e-4      # ba_cpu_vs_gpu
BA_POSE_TOL_RAD = 1e-4
BA_LM_TOL_M = 1e-3
WARM_FRAMES = 8
TIMED_RUNS = 25
LEVEL_SHAPES = [(480, 640), (400, 533), (333, 444), (278, 370),
                (231, 309), (193, 257), (161, 214), (134, 179)]
# Published peaks of one H100 SXM (dense): HBM, int8 tensor cores, f32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_OPS_PER_S = 67e12
# The H100 SXM's boost clock, and the f32 instructions one SM issues per
# clock (CUDA C++ Programming Guide, throughput table, compute capability
# 9.0): add 128, compare/minimum/maximum 64.  The 67 TFLOP/s above counts
# an FMA as two operations; K1's min/max issue at a quarter of that.
H100_BOOST_HZ = 1.98e9
FADD_PER_SM_CLOCK = 128
FMNMX_PER_SM_CLOCK = 64
# K1's arithmetic (csrc/fast_score.cu): per pixel 16 differences and 8
# compass compares; per ladder that the compass test lets run, 47
# min/max and 1 to combine
FAST_SUBS_PER_PIXEL = 16
FAST_COMPARES_PER_PIXEL = 8
FAST_MINMAX_PER_LADDER = 48


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


def bound(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes moved once over the
    memory rate, or operations over the peak rate for their type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_operations": n_ops}


def fast_ladder_runs(torch, levels) -> int:
    """Ladders K1 runs on these images: at each pixel `bright` where two
    compass pixels 4 apart on the circle are both brighter than the
    centre, `dark` where two are both darker."""
    from modular_slam_tpu_torch.ops.fast import FAST_CIRCLE

    runs = 0
    for img in levels:
        d = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img
                         for dy, dx in FAST_CIRCLE[::4]])
        for side in (d > 0, d < 0):
            runs += int((side & side.roll(-1, dims=0)).any(0).sum())
    return runs


def phase_k1(torch, frames, cfg) -> dict:
    from modular_slam_tpu_torch.io.tum import rgb_to_luma
    from modular_slam_tpu_torch.ops.fast import (fast_score_levels,
                                                 fast_score_plain)
    from modular_slam_tpu_torch.ops.pyramid import build_pyramid

    pyrs = [build_pyramid(rgb_to_luma(torch.as_tensor(rgb, device="cuda")),
                          cfg.detector) for rgb, _, _ in frames[:4]]
    check([tuple(x.shape) for x in pyrs[0]] == LEVEL_SHAPES,
          f"K1: pyramid shapes {[tuple(x.shape) for x in pyrs[0]]}")
    batch = [torch.stack(lv) for lv in zip(*pyrs)]      # 8 x [4, H, W]
    rows, max_err = {}, 0.0
    for name, levels in (("frame", pyrs[0]), ("batch_of_4", batch)):
        got = fast_score_levels(levels)
        ref = [fast_score_plain(x) for x in levels]
        torch.cuda.synchronize()
        bad = [int((a != b).sum()) for a, b in zip(got, ref)]
        check(not any(bad), f"K1: {bad} scores differ per level ({name})")
        max_err = max([max_err] + [float((a - b).abs().max())
                                   for a, b in zip(got, ref)])
        rows[name] = {
            "kernel": timings(torch, lambda: fast_score_levels(levels)),
            "plain": timings(torch,
                             lambda: [fast_score_plain(x) for x in levels])}
    pixels = sum(h * w for h, w in LEVEL_SHAPES)
    runs = fast_ladder_runs(torch, pyrs[0])
    n_subs = FAST_SUBS_PER_PIXEL * pixels
    n_minmax = FAST_COMPARES_PER_PIXEL * pixels + FAST_MINMAX_PER_LADDER * runs
    b = bound(8.0 * pixels, n_subs + n_minmax, F32_OPS_PER_S)
    sm_clocks = torch.cuda.get_device_properties(0).multi_processor_count \
        * H100_BOOST_HZ
    issue_ms = 1e3 * (n_subs / (FADD_PER_SM_CLOCK * sm_clocks)
                      + n_minmax / (FMNMX_PER_SM_CLOCK * sm_clocks))
    ms = rows["frame"]["kernel"]["device_ms"]
    emit({"phase": "K1", "tolerance": "exact on every pixel",
          "launches_per_frame": 1, "levels": LEVEL_SHAPES,
          "max_abs_err": max_err, **rows, **b,
          "share_of_bound": b["bound_ms"] / ms,
          "ladder_runs_per_pixel": runs / pixels,
          "issue_bound_ms": issue_ms, "share_of_issue_bound": issue_ms / ms})
    return {"max_abs_err": max_err, "ms": ms,
            "plain_ms": rows["frame"]["plain"]["device_ms"],
            "share_of_bound": b["bound_ms"] / ms, "library_ms": None, **b}


def _k2_problem(torch, seed: int, nq: int, nl: int, batch: int = 0):
    """±1 rows with planted near-duplicates (up to 8 flipped bits, so that
    real matches survive the ratio test), ~5 % invalid queries and ~10 %
    invalid landmark rows.  batch > 0 gives [batch, nq] queries against
    one shared landmark operand."""
    g = torch.Generator().manual_seed(seed)
    shape = (batch, nq) if batch else (nq,)
    q = (torch.randint(0, 2, (*shape, 256), generator=g) * 2 - 1).to(
        torch.int8)
    t = (torch.randint(0, 2, (nl, 256), generator=g) * 2 - 1).to(torch.int8)
    rows = torch.randperm(nl, generator=g)[:nq // 2]
    t[rows] = q.reshape(-1, nq, 256)[0, :nq // 2]
    flips = torch.randint(0, 256, (nq // 2, 8), generator=g)
    t[rows[:, None], flips] *= -1
    qv = torch.rand(shape, generator=g) > 0.05
    tv = torch.rand(nl, generator=g) > 0.10
    return tuple(x.cuda() for x in (q, qv, t, tv))


def _check_k2(torch, q, qv, t, tv, cfg, label: str) -> dict:
    """The fused path (K2 + merge) against the plain matcher, and K2's
    split triples against their plain version: both exact."""
    from modular_slam_tpu_torch.ops.match import (
        hamming_2nn_splits, hamming_2nn_splits_plain, hamming_n_splits,
        hamming_split_plan, match_descriptors, match_descriptors_plain)

    mk = match_descriptors(q, qv, t, tv, cfg.matcher)
    mp = match_descriptors_plain(q, qv, t, tv, cfg.matcher)
    batch = q.shape[0] if q.dim() == 3 else 1
    cps, S = hamming_split_plan(t.shape[-2], hamming_n_splits(
        q.shape[-2], batch, q.device))
    ks = hamming_2nn_splits(q, t, tv)
    ps = hamming_2nn_splits_plain(q, t, tv, cps)
    torch.cuda.synchronize()
    v = mp.valid
    check(torch.equal(mk.valid, mp.valid), f"K2 {label}: valid masks differ")
    check(torch.equal(mk.lm_slot[v], mp.lm_slot[v]),
          f"K2 {label}: lm_slot differs")
    check(torch.equal(mk.distance[v], mp.distance[v]),
          f"K2 {label}: distance differs")
    for name, a, b in zip(("best", "idx", "second"), ks, ps):
        check(tuple(a.shape) == tuple(b.shape) and torch.equal(a, b),
              f"K2 {label}: split {name} differs")
    n_valid = int(v.sum())
    check(n_valid >= q.shape[-2] // 4, f"K2 {label}: only {n_valid} matches")
    return {"shape": {"B": batch, "Nq": q.shape[-2], "L": t.shape[-2],
                      "S": S, "chunks_per_split": cps},
            "valid_matches": n_valid, "invalid_rows": int((~tv).sum()),
            "max_abs_err": float((mk.distance[v] - mp.distance[v]).abs()
                                 .max()),
            "split_max_abs_err": max(
                float((a - b).abs().max()) for a, b in
                ((ks[0], ps[0]), (ks[2], ps[2])))}


def phase_k2(torch, cfg) -> dict:
    from modular_slam_tpu_torch.ops.match import (
        _ratio_test, hamming_2nn_splits, hamming_2nn_splits_plain,
        match_descriptors, match_descriptors_plain, merge_tiles)

    Nq, L = cfg.detector.max_keypoints, cfg.map.max_landmarks
    q, qv, t, tv = _k2_problem(torch, 0, Nq, L)
    main = _check_k2(torch, q, qv, t, tv, cfg, "main")
    ragged = _check_k2(torch, *_k2_problem(torch, 1, 500, 16000, batch=2),
                       cfg, "ragged, batch of 2, shared landmarks")
    S, cps = main["shape"]["S"], main["shape"]["chunks_per_split"]
    splits = hamming_2nn_splits(q, t, tv)
    m = cfg.matcher

    def plain_merge():
        best, idx, second = merge_tiles(*splits)
        return _ratio_test(best, second, idx, qv, m)

    both = timings(torch, lambda: match_descriptors(q, qv, t, tv, m))
    k2 = {"ms": device_ms(torch, lambda: hamming_2nn_splits(q, t, tv),
                          name="hamming_2nn"),
          "plain_ms": device_ms(torch, lambda: hamming_2nn_splits_plain(
              q, t, tv, cps))}
    merge = {"ms": device_ms(torch, lambda: match_descriptors(
        q, qv, t, tv, m), name="hamming_merge"),
             "plain_ms": device_ms(torch, plain_merge)}
    try:   # the distance product alone: the only library call near K2
        k2["library_ms"] = device_ms(torch, lambda: torch._int_mm(q, t.t()))
        k2["library_note"] = "torch._int_mm(q, t.t()): the product only"
    except RuntimeError as e:
        k2["library_ms"] = None
        k2["library_note"] = f"torch._int_mm refused: {str(e)[:160]}"
    merge["library_ms"] = None
    plain = timings(torch, lambda: match_descriptors_plain(q, qv, t, tv, m))
    triples = 12.0 * S * Nq
    k2.update(bound(Nq * 256 + L * 256 + L + triples, 2.0 * Nq * L * 256,
                    INT8_OPS_PER_S))
    merge.update(bound(triples + Nq + 9.0 * Nq, 6.0 * S * Nq,
                       F32_OPS_PER_S))
    for k in (k2, merge):
        k["share_of_bound"] = k["bound_ms"] / k["ms"]
    k2["max_abs_err"] = max(main["split_max_abs_err"],
                            ragged["split_max_abs_err"])
    merge["max_abs_err"] = max(main["max_abs_err"], ragged["max_abs_err"])
    emit({"phase": "K2", "tolerance": "exact", "main": main,
          "ragged": ragged, "launches_per_match": 2,
          "kernel_plus_merge": both, "plain": plain, "hamming_2nn": k2,
          "hamming_merge": merge})
    return k2, merge


def _gt_array(poses):
    import numpy as np

    return np.array([[k / 30.0, *p.t, *p.q[1:], p.q[0]]
                     for k, p in enumerate(poses)], np.float64)


def phase_odometry(torch, kernels, frames, poses, cfg) -> dict:
    import numpy as np

    from modular_slam_tpu_torch.engine import SlamResult, SlamSystem
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.io.trajectory import trajectory_array

    system = SlamSystem(cfg, device="cuda", seed=0, enable_backend=False)
    kernels.reset_launch_counts()
    codes, wall = _run_frames(torch, system, frames)
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
    want = {"fast_score": n, "hamming_2nn": n - 1, "hamming_merge": n - 1}
    check(launches == want, f"odometry: launches {launches}, expected "
                            f"{want} (K1 once per frame, K2 and its merge "
                            f"once per tracked frame)")
    times = _frame_times(wall)
    emit({"phase": "odometry", "frames": n, "all_success": True,
          "ate_rmse_m": ate, "keyframes": system.n_keyframes,
          "landmarks": system.n_landmarks, "launches": launches,
          "frames_per_s": 1e3 / times["ms_per_frame"], **times})
    return launches, times["ms_per_frame"]


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
        system = SlamSystem(cfg, device=dev, enable_backend=False,
                            sampler=MultinomialSampler(0))
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
    system = SlamSystem(cfg, device="cuda", seed=0, enable_backend=False)
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


def _check_tf32(torch) -> None:
    """The BA einsums and solves must run in full float32."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the BA phases need full float32")


def _run_frames(torch, system, frames):
    """process() every frame, each ended by a device sync; -> (codes,
    wall seconds per frame)."""
    codes, wall = [], []
    for rgb, depth, ts in frames:
        t0 = time.perf_counter()
        codes.append(system.process(rgb, depth, ts))
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return codes, wall


def _check_track(system, codes, poses, label: str) -> dict:
    """Every frame SUCCESS; per-frame and keyframe ATE under the bound
    (keyframe rows hold the BA-corrected poses at the keyframe times)."""
    import numpy as np

    from modular_slam_tpu_torch.engine import SlamResult
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.io.trajectory import trajectory_array

    bad = [k for k, c in enumerate(codes) if c != SlamResult.SUCCESS]
    check(not bad, f"{label}: frames {bad} not SUCCESS")
    est = trajectory_array(system.trajectory)
    kfs = system.keyframe_trajectory()
    check(np.isfinite(est).all() and np.isfinite(kfs).all()
          and kfs.shape == (system.n_keyframes, 8),
          f"{label}: trajectory not finite or of the wrong shape")
    gt = _gt_array(poses)
    ate = ate_rmse(est, gt)["rmse"]
    kf_ate = ate_rmse(kfs, gt)["rmse"]
    check(ate < ATE_BOUND_M and kf_ate < ATE_BOUND_M,
          f"{label}: ATE {ate} m, keyframe ATE {kf_ate} m >= {ATE_BOUND_M}")
    return {"frames": len(codes), "all_success": True, "ate_rmse_m": ate,
            "keyframe_ate_rmse_m": kf_ate, "keyframes": system.n_keyframes,
            "landmarks": system.n_landmarks}


def _frame_times(wall) -> dict:
    warm = wall[WARM_FRAMES:]
    return {"ms_per_frame": 1e3 * sum(warm) / len(warm),
            "ms_per_frame_median": 1e3 * statistics.median(warm),
            "first_frame_ms": 1e3 * wall[0]}


def phase_slam(torch, kernels, frames, poses, cfg, odometry_ms=None,
               phase: str = "slam"):
    """The slam preset over the frames.  Each local-BA call is timed
    between two device syncs, and the window each one solved is counted
    on the device and read back at the end."""
    from modular_slam_tpu_torch.models import make_pipeline

    _check_tf32(torch)
    system = make_pipeline("slam", cfg, device="cuda", seed=0)
    ex = system._ensure_backend()
    ba_ms, sizes = [], []
    submit, extract = ex.submit, ex._extract

    def timed_submit(arena, state, kf_slot):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = submit(arena, state, kf_slot)
        torch.cuda.synchronize()
        ba_ms.append((len(system.results) - 1, 1e3 * (time.perf_counter()
                                                      - t0)))
        return out

    def counted_extract(arena, kf_slot):
        prob = extract(arena, kf_slot)
        sizes.append(torch.stack([prob.kf_ok.sum(), prob.lm_ok.sum(),
                                  (prob.obs.w > 0).sum()]))
        return prob

    ex.submit, ex._extract = timed_submit, counted_extract
    kernels.reset_launch_counts()
    codes, wall = _run_frames(torch, system, frames)
    launches = kernels.launch_counts()

    out = _check_track(system, codes, poses, phase)
    n = len(frames)
    want = {"fast_score": n, "hamming_2nn": n - 1, "hamming_merge": n - 1}
    check(launches == want, f"{phase}: launches {launches}, expected {want}")
    new_kf = sum(bool(r.new_keyframe) for r in system.results)
    check(ex.n_submitted == len(ba_ms) == new_kf == system.n_keyframes,
          f"{phase}: {ex.n_submitted} BA calls, {new_kf} new keyframes")
    windows = torch.stack(sizes).cpu().tolist()
    bcfg = cfg.backend
    warm_ba = [ms for frame, ms in ba_ms if frame >= WARM_FRAMES]
    emit({"phase": phase, **out, "launches": launches,
          **_frame_times(wall), "odometry_ms_per_frame": odometry_ms,
          "ba_calls": ex.n_submitted, "new_keyframes": new_kf,
          "ba_ms_per_call": sum(warm_ba) / len(warm_ba),
          "ba_ms_per_call_median": statistics.median(warm_ba),
          "ba_ms_first_call": ba_ms[0][1],
          "ba_ms_by_frame": ba_ms,
          "window_caps": [bcfg.local_kf_cap, bcfg.local_lm_cap,
                          bcfg.local_obs_cap],
          "windows_kf_lm_obs": windows,
          "window_max": [max(w[i] for w in windows) for i in range(3)]})
    return system


def phase_slam_async(torch, frames, poses, cfg,
                     phase: str = "slam_async") -> None:
    from modular_slam_tpu_torch.models import make_pipeline

    _check_tf32(torch)
    system = make_pipeline("slam", cfg, device="cuda", seed=0,
                           ba_mode="async")
    try:
        codes, wall = _run_frames(torch, system, frames)
        system.flush_backend()
        out = _check_track(system, codes, poses, phase)
        ex = system._backend
        check(ex.n_merged == ex.n_submitted == system.n_keyframes,
              f"{phase}: {ex.n_merged} merged of {ex.n_submitted} "
              f"submitted, {system.n_keyframes} keyframes")
        emit({"phase": phase, **out, **_frame_times(wall),
              "ba_submitted": ex.n_submitted, "ba_merged": ex.n_merged})
    finally:
        if system._backend is not None:
            system._backend.close()


def _arena_on(arena, device):
    """A copy of the arena on `device` (BA updates an arena in place)."""
    return type(arena)(*(x.to(device, copy=True) for x in arena))


def _pose_diffs(torch, q_a, t_a, q_b, t_b, rows) -> tuple:
    dt = float((t_a[rows].double() - t_b[rows].double()).abs().max())
    dr = max(_rot_angle(a, b) for a, b in zip(q_a[rows].double(),
                                               q_b[rows].double()))
    return dt, dr


def phase_ba_cpu_vs_gpu(torch, system, cfg) -> None:
    """The slam run's last window, and a compact global BA of its map, on
    "cpu" (deterministic sums) and on "cuda"."""
    from modular_slam_tpu_torch.backend.ba import (
        extract_window, global_ba_tier, local_ba_config,
        make_global_ba_compact, solve_window)
    from modular_slam_tpu_torch.backend.executor import _to
    from modular_slam_tpu_torch.geometry.camera import camera_from_config

    _check_tf32(torch)
    bcfg = local_ba_config(cfg)
    kf_slot = system.n_keyframes - 1
    prob = extract_window(camera_from_config(cfg.camera, "cuda"),
                          system.arena, kf_slot, bcfg)
    sols = {"cuda": solve_window(camera_from_config(cfg.camera, "cuda"),
                                 prob, bcfg),
            "cpu": solve_window(camera_from_config(cfg.camera, "cpu"),
                                _to(prob, "cpu"), bcfg)}
    g, c = (_to(sols[d], "cpu") for d in ("cuda", "cpu"))
    kf_ok, lm_ok = prob.kf_ok.cpu(), prob.lm_ok.cpu()
    dt, dr = _pose_diffs(torch, g.kf_q, g.kf_t, c.kf_q, c.kf_t, kf_ok)
    dl = float((g.lm_pos[lm_ok] - c.lm_pos[lm_ok]).abs().max())
    check(dt <= BA_POSE_TOL_M and dr <= BA_POSE_TOL_RAD
          and dl <= BA_LM_TOL_M, f"ba_cpu_vs_gpu: window differs by {dt} m, "
                                 f"{dr} rad, landmarks {dl} m")
    check(torch.equal(g.bad, c.bad), "ba_cpu_vs_gpu: window outliers differ")
    local = {"max_dt_m": dt, "max_drot_rad": dr, "max_dlm_m": dl,
             "outliers": int(c.bad.sum()),
             "iterations": {"cpu": c.stats.n_iterations,
                            "cuda": g.stats.n_iterations},
             "final_cost": {"cpu": float(c.stats.final_cost),
                            "cuda": float(g.stats.final_cost)},
             "window_kf_lm_obs": [int(kf_ok.sum()), int(lm_ok.sum()),
                                  int((prob.obs.w > 0).sum())]}

    tier = global_ba_tier(system.arena)
    runs = {d: make_global_ba_compact(cfg, tier, device=d)(
        _arena_on(system.arena, d)) for d in ("cuda", "cpu")}
    (ga, gs), (ca, cs) = ((_arena_on(a, "cpu"), st)
                          for a, st in (runs["cuda"], runs["cpu"]))
    dt, dr = _pose_diffs(torch, ga.kf_q, ga.kf_t, ca.kf_q, ca.kf_t,
                         ca.kf_valid)
    dl = float((ga.lm_pos[ca.lm_valid] - ca.lm_pos[ca.lm_valid]).abs().max())
    check(dt <= BA_POSE_TOL_M and dr <= BA_POSE_TOL_RAD
          and dl <= BA_LM_TOL_M, f"ba_cpu_vs_gpu: global BA differs by {dt} "
                                 f"m, {dr} rad, landmarks {dl} m")
    check(torch.equal(ga.obs_valid, ca.obs_valid),
          "ba_cpu_vs_gpu: global BA obs_valid differs")
    emit({"phase": "ba_cpu_vs_gpu", "tol_m": BA_POSE_TOL_M,
          "tol_rad": BA_POSE_TOL_RAD, "lm_tol_m": BA_LM_TOL_M,
          "local_window": local,
          "global_compact": {
              "tier": tier, "max_dt_m": dt, "max_drot_rad": dr,
              "max_dlm_m": dl, "outliers": int(cs.n_outliers),
              "iterations": {"cpu": cs.n_iterations,
                             "cuda": gs.n_iterations},
              "final_cost": {"cpu": float(cs.final_cost),
                             "cuda": float(gs.final_cost)}}})


def _traced(torch, fn):
    """One call of fn under a CUDA-only trace, with host syncs counted by
    the sync debug mode.  -> (fn's result, {wall ms ended by a device
    sync, device busy ms, device ops, syncs, the top 8 device ops})."""
    import traceback
    import warnings

    from torch.profiler import ProfilerActivity, profile

    sites = collections.Counter()
    root = os.path.dirname(os.path.abspath(__file__))
    inside = [False]

    def count_sync(message, category, filename, lineno, *rest):
        """Count a sync raised inside fn at the innermost frame of this
        repository."""
        if not inside[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]
                if f.filename.startswith(root)]
        at = ours[-1] if ours else None
        sites[f"{os.path.relpath(at.filename, root)}:{at.lineno}" if at
              else f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = count_sync
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("warn")
            inside[0] = True
            try:
                out = fn()
            finally:
                inside[0] = False
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = sorted(prof.key_averages(), key=_device_us, reverse=True)
    return out, {
        "wall_ms": 1e3 * wall,
        "device_busy_ms": sum(_device_us(e) for e in events) / 1e3,
        "device_ops": sum(e.count for e in events),
        "host_syncs": sum(sites.values()),
        "host_sync_sites": dict(sites),
        "top_device_ops": [{"name": e.key[:120], "calls": e.count,
                            "ms": _device_us(e) / 1e3} for e in events[:8]]}


def phase_ba_profile(torch, system, cfg) -> None:
    """One local-BA call (extract, solve, merge: what the engine runs per
    keyframe) on the slam run's last keyframe, and one compact global BA
    of its map, each after an untraced warm-up call on a copy."""
    from modular_slam_tpu_torch.backend.ba import (
        extract_window, global_ba_tier, local_ba_config,
        make_global_ba_compact, merge_window, solve_window)
    from modular_slam_tpu_torch.geometry.camera import camera_from_config

    _check_tf32(torch)
    cam = camera_from_config(cfg.camera, "cuda")
    bcfg = local_ba_config(cfg)
    kf_slot = system.n_keyframes - 1

    def local_ba(arena):
        prob = extract_window(cam, arena, kf_slot, bcfg)
        sol = solve_window(cam, prob, bcfg)
        merge_window(arena, system.state, prob, sol)
        return sol.stats

    tier = global_ba_tier(system.arena)
    gba = make_global_ba_compact(cfg, tier, device="cuda")
    rows = {}
    for name, fn in (("local_ba", local_ba),
                     ("global_ba_compact", lambda a: gba(a)[1])):
        fn(_arena_on(system.arena, "cuda"))
        arena = _arena_on(system.arena, "cuda")
        stats, row = _traced(torch, lambda: fn(arena))
        rows[name] = {"lm_iterations": stats.n_iterations, **row}
    emit({"phase": "ba_profile", "global_tier": tier, **rows})


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
    fast_poses = gen.trajectory(
        N_FRAMES, step_t=tuple(FAST_MOTION * x for x in STEP_T),
        step_rot=tuple(FAST_MOTION * x for x in STEP_ROT))
    fast_frames = list(gen.sequence(fast_poses))

    phase_build(kernels)
    k1 = phase_k1(torch, frames, cfg)
    k2, merge = phase_k2(torch, cfg)
    launches, ms_per_frame = phase_odometry(torch, kernels, frames, poses,
                                            cfg)
    phase_cpu_vs_gpu(torch, frames[:N_CMP_FRAMES], cfg)
    phase_profile(torch, frames, cfg, ms_per_frame)
    phase_slam(torch, kernels, frames, poses, cfg, ms_per_frame)
    slam = phase_slam(torch, kernels, fast_frames, fast_poses, cfg,
                      phase="slam_fast_motion")
    phase_slam_async(torch, frames, poses, cfg)
    phase_slam_async(torch, fast_frames, fast_poses, cfg,
                     phase="slam_async_fast_motion")
    phase_ba_cpu_vs_gpu(torch, slam, cfg)
    phase_ba_profile(torch, slam, cfg)

    timing = {"fast_score": k1, "hamming_2nn": k2, "hamming_merge": merge}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "library_ms")
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source_relpath,
         "replaces": k.replaces, "launches": launches[k.name],
         **{key: timing[k.name][key] for key in keys}}
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
