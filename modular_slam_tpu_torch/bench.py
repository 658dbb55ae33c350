"""Benchmark of the port: SLAM throughput, frames/s on one card
(counterpart of the repository's `bench.py`, function for function).

    python -m modular_slam_tpu_torch.bench [--device cuda]   (mslam-torch-bench)

Prints ONE JSON line last: `bench.py`'s headline keys plus `gpu`, the
card's name and power limit as `nvidia-smi` reads them.  The full detail
goes to `reports/bench_torch_detail.json`.  The workload is `bench.py`'s:
default `SlamConfig()` (640x480), 67 frames of `PlaneSceneGenerator(seed
42)` with its steps, 3 warm-up frames and chunks of 16.  The headline
metric is frames/s of the `slam` preset (tracking + local BA per keyframe)
through the chunked engine path in deferred-pipelined mode
(`defer_chunk_sync=True`): the host finishes chunk N's bookkeeping while
the card runs chunk N+1.  Also reported, as in `bench.py`: the sync and
async-offload variants, tracking-only throughput, per-stage probes, the
box and degraded scenes, loop-closure latency and accuracy, and the time
to the first chunk.

What differs from `bench.py`, and why:

- The RANSAC draws are JAX's: the keys are split as `bench.py` splits
  them (utils/prng.py).  The port's `sampler` (a RANSAC triplet sampler,
  ops/pnp.py) draws in their place when given; it and the port's
  `device` (default "cuda", RuntimeError without a CUDA device) are
  keyword-only.
- A timed region ends in one `torch.cuda.synchronize()`, the JAX
  `block_until_ready`; nothing inside it waits for the card.
- The stage probes: JAX runs each stage inside one `lax.scan` over 64
  different frames.  Here each is a Python loop over the same 64 frames
  with no host read inside, timed from a CUDA event before its first
  launch to one after its last, divided by the count.  Each probe
  consumes every output, as JAX's does.  JAX's `match_xla_ms` /
  `match_pallas_ms` become `match_plain_ms` (the plain PyTorch matcher on
  the card, a yardstick only: the engine never runs it there) and
  `match_kernel_ms` (the K2 kernel and its merge).  The detail adds each
  probe's device-busy ms per frame (the sum of the card's kernel and copy
  times in a `torch.profiler` trace) and the launches of the port's three
  kernels in that trace.
- `bench_startup` includes loading, or building with `nvcc`, the three
  kernel libraries; the detail says whether `nvcc` ran.
- `bench_loop` compiles nothing: before the timed region it calls the
  closure chain once (verification, PGO, global BA, fusion) and runs one
  global BA per tier that JAX would have compiled, so the first timed
  closure measures execution only.  `gba_tiers_compiled` becomes
  `gba_tiers_visited`.
- The baseline is `bench.py`'s host-CPU proxy of the C++ reference
  pipeline (OpenCV ORB + brute-force Hamming + solvePnPRansac, plus a
  numpy Schur-LM local BA per keyframe), copied here.  It is no fallback
  of the card or of a kernel.  Where OpenCV is not installed, the live
  proxy's fields are null (`baseline_live: "cv2 absent"`), and the ratios
  use the pinned proxy, `BASELINE_PROXY.json`, which was measured on
  another host (named in the file).  Without OpenCV the synthetic scenes
  are not blurred (eval/synthetic.py), so the frames differ from those of
  a machine that has it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from modular_slam_tpu_torch.engine import _resolve_device, make_slam_scan
from modular_slam_tpu_torch.io.tum import rgb_to_luma
from modular_slam_tpu_torch.utils.device import upload
from modular_slam_tpu_torch.utils.prng import prng_key, split

N_FRAMES = 67
WARMUP = 3
CHUNK = 16  # frames per chunk (amortizes the per-chunk host round trip)
BA_WINDOW = 3  # proxy local-BA keyframe window (1-hop covis stand-in)
PROBE_FRAMES = 32  # distinct frames of a stage probe, run twice over

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETAIL = os.path.join("reports", "bench_torch_detail.json")

# the port's kernels (ops/kernels.py) by the name of their __global__
# function in csrc/, as a profiler trace shows them
KERNEL_SYMBOLS = {"fast_score": "fast_score_levels_kernel",
                  "hamming_2nn": "hamming_2nn_kernel",
                  "hamming_merge": "hamming_merge_kernel"}


def _sequence(generator="plane"):
    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.eval.synthetic import (BoxSceneGenerator,
                                                       PlaneSceneGenerator)

    cfg = SlamConfig()
    gen_cls = {"plane": PlaneSceneGenerator, "box": BoxSceneGenerator}
    gen = gen_cls[generator](cfg.camera, seed=42)
    # enough motion that landmarks leave the view and keyframes + local BA
    # fire at a realistic rate (~1 keyframe / 15 frames)
    poses = gen.trajectory(N_FRAMES, step_t=(0.05, 0.02, 0.01),
                           step_rot=(0.004, 0.008, 0.004))
    frames = [(rgb, depth, ts) for rgb, depth, ts in gen.sequence(poses)]
    return cfg, frames, poses


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stage_frames(frames, *, device="cuda"):
    """Stack the frames onto the device once (the loader is not what is
    measured): luma with `bench.py`'s weights, depth, times."""
    dev = _resolve_device(device)
    grays = rgb_to_luma(upload(np.stack([rgb for rgb, _, _ in frames]), dev))
    depths = upload(np.stack([np.asarray(d, np.float32)
                              for _, d, _ in frames]), dev)
    times = upload(np.asarray([ts for _, _, ts in frames], np.float32), dev)
    _sync(dev)
    return grays, depths, times


def _clone(tree):
    """A copy of a NamedTuple of tensors (nested ones too): the port
    updates arenas in place where JAX returns new arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    return tree


def _event(device):
    """A CUDA event recorded on the current stream (None on the CPU)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _region_ms(run, device) -> float:
    """ms of run(): from a CUDA event before its first launch to one after
    its last, then one synchronize; the host clock on the CPU."""
    start = _event(device)
    t0 = time.perf_counter()
    run()
    end = _event(device)
    if end is None:
        return (time.perf_counter() - t0) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def _profiled(run, device, per: int):
    """(device-busy ms per item, {kernel: launches}) of run() from a
    torch.profiler trace: the sum of the card's kernel and copy times, and
    the launches of the port's kernels in it.  (None, None) on the CPU,
    which has no device time.  A trace that holds no device event (the
    tracer drops one now and then) is taken again, twice at most."""
    if torch.device(device).type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    busy_ns, seen = 0, {}
    for _ in range(3):
        _sync(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            _sync(device)
        busy_ns, seen = 0, dict.fromkeys(KERNEL_SYMBOLS, 0)
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            busy_ns += e.duration_ns()
            for name, symbol in KERNEL_SYMBOLS.items():
                if symbol in e.name():
                    seen[name] += 1
        if busy_ns > 0:
            break
    return busy_ns / 1e6 / per, seen


def _libraries_to_build():
    """The kernels whose library `nvcc` must still build (none loaded in
    this process has one missing)."""
    from modular_slam_tpu_torch.ops.kernels import KERNELS

    return [k.name for k in KERNELS.values()
            if not os.path.exists(k.library_path())]


def _card(device) -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of the card (its name and
    "power limit not read" where nvidia-smi fails); None on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        lines = out.stdout.strip().splitlines()
        if out.returncode == 0 and lines:
            return lines[dev.index or 0].strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


# ---------------------------------------------------------------------------
# ours
# ---------------------------------------------------------------------------


def bench_startup(cfg, frames, *, device="cuda") -> float:
    """Time to the first tracked chunk: a fresh `slam_pipeline` and one
    chunk through it, loading (or building) the kernel libraries on the
    card.  Run FIRST, so that nothing is loaded in this process yet."""
    from modular_slam_tpu_torch.models.pipelines import slam_pipeline

    dev = _resolve_device(device)
    t0 = time.perf_counter()
    system = slam_pipeline(cfg, defer_chunk_sync=True, device=dev)
    grays, depths, _ = _stage_frames(frames[:CHUNK], device=dev)
    system.process_chunk_device(grays, depths,
                                [ts for _, _, ts in frames[:CHUNK]])
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"startup to first chunk: {dt:.1f}s", file=sys.stderr)
    return dt


class _Every:
    """A sampler that also stands for a sequence of keys: `[i]` and
    `[lo:hi]` give it back, and it draws as the sampler it wraps."""

    def __init__(self, sampler):
        self.sampler = sampler

    def __getitem__(self, i):
        return self

    def __call__(self, valid, n_hyp):
        return self.sampler(valid, n_hyp)


def _keys(sampler, n: int):
    """`split(PRNGKey(0), n)`, as `bench.py` keys its frames, or the given
    sampler in every key's place."""
    return split(prng_key(0), n) if sampler is None else _Every(sampler)


def bench_ours_tracking(cfg, frames, *, device="cuda", sampler=None,
                        detail: Optional[dict] = None) -> float:
    """Tracking-only chunked path (detect + match + PnP + arena), frames/s.

    The three timed chunks run with no sync between them and one
    `torch.cuda.synchronize()` after the last.  `detail`, when given,
    receives each timed chunk's ms (`chunk_ms`: from the CUDA event after
    the previous chunk's launches, or before the first, to the one after
    its own; read after the final sync) and host ms (`chunk_host_ms`:
    from the previous chunk's call returning, or the start, to its own),
    and the tracked count."""
    dev = _resolve_device(device)
    scan = make_slam_scan(cfg, device=dev)
    from modular_slam_tpu_torch.frontend.tracker import initial_state
    from modular_slam_tpu_torch.map.arena import empty_arena

    arena = empty_arena(cfg.map, dev)
    state = initial_state(dev)
    keys = _keys(sampler, len(frames))
    grays, depths, times = _stage_frames(frames, device=dev)

    def chunk(a, s, lo, hi):
        return scan(a, s, grays[lo:hi], depths[lo:hi], times[lo:hi],
                    keys[lo:hi], bootstrap=lo == 0)

    # warmup (bootstrap + both chunk shapes)
    arena, state, _ = chunk(arena, state, 0, WARMUP)
    arena, state, _ = chunk(arena, state, WARMUP, WARMUP + CHUNK)
    _sync(dev)

    n = len(frames) - WARMUP - CHUNK
    assert n % CHUNK == 0, (n, CHUNK)
    oks, events, returned = [], [], []
    t0 = time.perf_counter()
    start = _event(dev)
    for lo in range(WARMUP + CHUNK, len(frames), CHUNK):
        arena, state, res = chunk(arena, state, lo, lo + CHUNK)
        oks.append(res.tracking_ok)
        events.append(_event(dev))
        returned.append(time.perf_counter())
    _sync(dev)
    dt = time.perf_counter() - t0

    ok = int(torch.cat(oks).sum())
    print(f"ours tracking: {n} frames in {dt:.3f}s, {ok}/{n} tracked ok",
          file=sys.stderr)
    if detail is not None:
        host = np.diff([t0] + returned) * 1e3
        detail.update({
            "n_frames": n, "tracked_ok": ok, "seconds": dt,
            "chunk_host_ms": host.tolist(),
            "chunk_ms": (None if start is None else np.diff(
                [0.0] + [start.elapsed_time(e) for e in events]).tolist())})
    return n / dt


def bench_ours_full(cfg, frames, mode="pipelined", ba_mode="sync", *,
                    device="cuda", sampler=None):
    """Full slam pipeline (tracking + per-keyframe local BA) through the
    chunked engine path, steady state: frames staged on the device, the
    first chunk is warm-up, the remaining frames are timed INCLUDING every
    keyframe's BA (inline in sync mode; submit + harvest in async mode),
    the per-chunk results fetch and a final `flush_backend()`.
    Returns (fps, n_keyframes, n_tracked, system)."""
    from modular_slam_tpu_torch.models.pipelines import slam_pipeline

    dev = _resolve_device(device)
    system = slam_pipeline(cfg, defer_chunk_sync=(mode == "pipelined"),
                           ba_mode=ba_mode, device=dev, sampler=sampler)
    grays, depths, _ = _stage_frames(frames, device=dev)
    tss = [ts for _, _, ts in frames]

    system.process_chunk_device(grays[:CHUNK], depths[:CHUNK], tss[:CHUNK])
    system.flush_backend()
    _sync(dev)

    n = (len(frames) - CHUNK) // CHUNK * CHUNK
    t0 = time.perf_counter()
    for lo in range(CHUNK, CHUNK + n, CHUNK):
        system.process_chunk_device(grays[lo:lo + CHUNK],
                                    depths[lo:lo + CHUNK],
                                    tss[lo:lo + CHUNK])
    system.flush_backend()
    _sync(dev)
    dt = time.perf_counter() - t0

    n_ok = sum(1 for r in system.results if bool(r.tracking_ok))
    print(f"ours tracking+BA[{mode}/{ba_mode}]: {n} frames in {dt:.3f}s, "
          f"{system.n_keyframes} keyframes (BA each), "
          f"{n_ok}/{len(system.results)} ok", file=sys.stderr)
    return n / dt, system.n_keyframes, n_ok, system


def bench_stages(cfg, frames, *, device="cuda", sampler=None) -> dict:
    """Per-stage steady-state ms per frame from STAGE PROBES: each stage
    runs in a loop over 64 frames (32 distinct, twice) with no host read
    inside, timed between CUDA events around the whole loop (warmed by
    one run before).  `device_busy_ms_per_frame` gives each probe's
    device-busy ms per frame from a profiled run, and
    `kernels_in_profile` the port's kernel launches in each trace."""
    from modular_slam_tpu_torch.backend.ba import (extract_window,
                                                   local_ba_config,
                                                   merge_window,
                                                   solve_window)
    from modular_slam_tpu_torch.frontend.tracker import (initial_state,
                                                         track_frame)
    from modular_slam_tpu_torch.geometry.camera import camera_from_config
    from modular_slam_tpu_torch.map.arena import empty_arena
    from modular_slam_tpu_torch.ops.detector import detect
    from modular_slam_tpu_torch.ops.match import (match_descriptors,
                                                  match_descriptors_plain)

    dev = _resolve_device(device)
    cam = camera_from_config(cfg.camera, dev)
    n0 = PROBE_FRAMES
    grays0, depths0, times0 = _stage_frames(frames[WARMUP:WARMUP + n0],
                                            device=dev)
    n = 2 * n0
    grays = torch.cat([grays0, grays0])
    depths = torch.cat([depths0, depths0])
    times = torch.cat([times0, times0 + 100.0])
    keys = _keys(sampler, n)
    busy, in_profile = {}, {}

    def timed(name, run, prepare=tuple, per=n):
        """ms per item of run(*prepare()), the arguments made outside the
        timed region; warmed by one run."""
        run(*prepare())
        _sync(dev)
        args = prepare()
        _sync(dev)
        ms = _region_ms(lambda: run(*args), dev) / per
        args = prepare()
        busy[name], in_profile[name] = _profiled(lambda: run(*args), dev,
                                                 per)
        return ms

    def zero():
        return torch.zeros((), dtype=torch.float32, device=dev)

    # -- detect only ---------------------------------------------------------
    def run_detect(gs, ds):
        c = zero()
        for i in range(gs.shape[0]):
            f = detect(gs[i], ds[i], cfg.detector)
            # consume EVERY output, as JAX's probe does
            c = (c + torch.sum(f.keypoints.uv)
                 + torch.sum(f.descriptors.unpacked.to(torch.float32))
                 + torch.sum(f.keypoints.angle)
                 + torch.sum(f.keypoints.depth))
        return c

    detect_ms = timed("detect", run_detect, lambda: (grays, depths))

    # -- full step (detect + track) ------------------------------------------
    # build a realistic tracked arena first (also yields per-frame features)
    scan_f = make_slam_scan(cfg, with_features=True, device=dev)
    arena, state, (_, feats) = scan_f(
        empty_arena(cfg.map, dev), initial_state(dev), grays, depths, times,
        keys, bootstrap=True)
    _sync(dev)

    def run_step(a, s):
        out = []
        for i in range(n):
            f = detect(grays[i], depths[i], cfg.detector)
            a, s, r = track_frame(a, s, f, cam, cfg, times[i], keys[i],
                                  bootstrap=False)
            out.append(r.n_inliers)
        return torch.stack(out)

    # every run starts from a copy of the same tracked map, as JAX's does
    step_ms = timed("step", run_step, lambda: (_clone(arena), _clone(state)))

    # -- track only (pre-computed features) ----------------------------------
    def run_track(a, s):
        out = []
        for i in range(n):
            a, s, r = track_frame(a, s, feats[i], cam, cfg, times[i],
                                  keys[i], bootstrap=False)
            out.append(r.n_inliers)
        return torch.stack(out)

    track_ms = timed("track_only", run_track,
                     lambda: (_clone(arena), _clone(state)))

    # -- local BA: extract + solve + merge over the tracked arena's
    #    keyframes (a different window per step); each step merges into a
    #    copy of the map of its own, as JAX's merges into a discarded one --
    bcfg = local_ba_config(cfg)
    n_kf = max(int(arena.n_kf), 1)
    slots = [i % n_kf for i in range(16)]

    def run_ba(arenas):
        c = zero()
        for a, slot in zip(arenas, slots):
            prob = extract_window(cam, a, slot, bcfg)
            sol = solve_window(cam, prob, bcfg)
            a2, s2 = merge_window(a, state, prob, sol)
            c = c + torch.sum(a2.kf_t) + s2.pose.t[0]
        return c

    ba_ms = timed("local_ba", run_ba,
                  lambda: ([_clone(arena) for _ in slots],), per=len(slots))

    # -- matcher head-to-head (plain PyTorch vs K2 + merge) on the tracked
    #    arena -----------------------------------------------------------------
    qs = torch.stack([f.descriptors.unpacked for f in feats])
    qvs = torch.stack([f.keypoints.valid for f in feats])

    def match_probe(name, match_fn):
        def run():
            c = zero()
            for i in range(n):
                m = match_fn(qs[i], qvs[i], arena.lm_desc, arena.lm_valid,
                             cfg.matcher)
                c = c + torch.sum(m.distance)
            return c
        return timed(name, run)

    match_plain_ms = match_probe("match_plain", match_descriptors_plain)
    out_match = {"match_plain_ms": round(match_plain_ms, 3)}
    if dev.type == "cuda":
        out_match["match_kernel_ms"] = round(
            match_probe("match_kernel", match_descriptors), 3)

    kf_rate = n_kf / n  # keyframes per frame on this sequence
    return {
        "detect_ms": round(detect_ms, 3),
        "step_ms": round(step_ms, 3),
        "track_only_ms": round(track_ms, 3),
        "detect_in_step_ms": round(step_ms - track_ms, 3),
        "local_ba_ms": round(ba_ms, 3),
        "local_ba_amortized_ms_per_frame": round(ba_ms * kf_rate, 3),
        "keyframes_per_frame": round(kf_rate, 4),
        **out_match,
        "device_busy_ms_per_frame": busy,
        "kernels_in_profile": in_profile,
    }


def _has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def bench_degraded(n_frames=None, *, device="cuda", sampler=None) -> dict:
    """Tracking+BA on the DEGRADED plane world (photometric noise,
    exposure jitter, motion blur where OpenCV is installed, a moving
    distractor with its own depth — eval/synthetic.py DegradedScene):
    throughput, tracked count and ATE against exact ground truth."""
    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.eval.synthetic import (DegradedScene,
                                                       PlaneSceneGenerator)

    cfg = SlamConfig()
    base = PlaneSceneGenerator(cfg.camera, seed=42, depth_noise=0.01)
    gen = DegradedScene(base, seed=42)
    n = n_frames or N_FRAMES
    poses = base.trajectory(n, step_t=(0.05, 0.02, 0.01),
                            step_rot=(0.004, 0.008, 0.004))
    frames = [(rgb, depth, ts) for rgb, depth, ts in gen.sequence(poses)]
    fps, n_kf, n_ok, system = bench_ours_full(
        cfg, frames, mode="pipelined", device=device, sampler=sampler)
    est = _trajectory_rows(system)
    out = {
        "tracking_ba_fps": round(fps, 3),
        "tracked_ok": int(n_ok),
        "n_frames": len(frames),
        "n_keyframes": int(n_kf),
        "degradations": "noise sigma=4, exposure jitter 12%, 5px motion "
                        "blur, moving distractor w/ own depth, "
                        "depth noise 1cm",
    }
    if not _has_cv2():
        out["degradations"] += " (no motion or texture blur: cv2 absent)"
    try:
        out["ate_rmse_m"] = round(ate_rmse(est, _gt_rows(poses))["rmse"], 4)
    except ValueError as e:
        out["ate_error"] = str(e)
    print(f"degraded world: {out}", file=sys.stderr)
    return out


def _trajectory_rows(system) -> np.ndarray:
    """[N, 8] TUM rows (t x y z qx qy qz qw) of a system's per-frame
    trajectory."""
    return np.array([
        [ts, float(p.t[0]), float(p.t[1]), float(p.t[2]),
         float(p.q[1]), float(p.q[2]), float(p.q[3]), float(p.q[0])]
        for ts, p in system.trajectory])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _score_closures(system, poses, min_gap, thr=0.35, opp_thr=0.5,
                    sweep=(0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)) -> dict:
    """Score accepted closures against synthetic ground truth (a copy of
    `bench.py`'s, on host copies of the map): a closure is a TRUE positive
    when the MEASURED query pose from geometric verification lands within
    `thr` meters of the query keyframe's ground-truth position.  Recall
    counts keyframes that had a true revisit available (some prior
    keyframe >= min_gap back within `opp_thr` of the same place) and fired
    a closure, were map-connected to it, or fell in a true closure's
    cooldown.  The post-hoc score sweep reuses the event log: a closure
    accepted with BoW score s would have fired at any gate <= s."""
    kf_time = _host(system.arena.kf_time)
    kf_valid = _host(system.arena.kf_valid)
    gt_pos = np.array([np.asarray(p.t) for p in poses])

    def slot_gt(slot):
        fi = int(round(kf_time[slot] * 30.0))
        return gt_pos[min(fi, len(gt_pos) - 1)]

    events = []
    for cur, cand, n_inl, score, meas_t in system._loop.closures:
        err = float(np.linalg.norm(np.asarray(meas_t) - slot_gt(cur)))
        events.append((cur, cand, n_inl, score, err < thr))
    tp = sum(1 for e in events if e[4])
    fp = len(events) - tp

    valid_slots = np.nonzero(kf_valid)[0]       # slot order = recency order
    # a revisit is "recognized" when a closure fired at that keyframe OR
    # the map already connects it to a nearby prior keyframe (shared
    # landmarks past the covisibility gate's threshold), which correctly
    # suppresses a redundant loop edge
    inc = _host(system.arena.inc)
    covis_thr = system.cfg.loop.max_covis_overlap
    cooldown = system.cfg.loop.closure_cooldown_keyframes
    opp, hit_closure, hit_connected, hit_cooldown = 0, 0, 0, 0
    # only TRUE-POSITIVE closures recognize a revisit or open a credited
    # cooldown window: a false positive must not launder the
    # opportunities around it into hits
    closed_tp = {cur for cur, _, _, _, is_tp in events if is_tp}
    last_closed_i = -(10 ** 9)
    opp_rows = []   # (time, recognized) per opportunity keyframe
    for i, s in enumerate(valid_slots):
        prior = valid_slots[: max(0, i - min_gap)]
        if len(prior) == 0:
            continue
        near = [p for p in prior
                if float(np.linalg.norm(slot_gt(s) - slot_gt(p))) < opp_thr]
        if not near:
            continue
        opp += 1
        recognized = False
        if s in closed_tp:
            hit_closure += 1
            last_closed_i = i
            recognized = True
        elif any(int((inc[s] & inc[p]).sum()) > covis_thr for p in near):
            hit_connected += 1
            recognized = True
        elif i - last_closed_i <= cooldown:
            hit_cooldown += 1  # suppressed by a true closure's cooldown
            recognized = True
        opp_rows.append((float(kf_time[s]), recognized))
    # EPISODE recall: temporally contiguous opportunity keyframes are one
    # revisit EVENT; episodes break on a > ep_gap_s gap between them
    ep_gap_s = 10.0 / 30.0
    episodes, ep_hits = 0, 0
    j = 0
    while j < len(opp_rows):
        k = j
        hit_ep = False
        while k < len(opp_rows) and (
                k == j or opp_rows[k][0] - opp_rows[k - 1][0] <= ep_gap_s):
            hit_ep = hit_ep or opp_rows[k][1]
            k += 1
        episodes += 1
        ep_hits += int(hit_ep)
        j = k
    hit = hit_closure + hit_connected + hit_cooldown
    out = {
        "closures": len(events),
        "true_positives": tp,
        "false_positives": fp,
        "recall": round(hit / opp, 3) if opp else None,
        "episode_recall": round(ep_hits / episodes, 3) if episodes else None,
        "revisit_episodes": episodes,
        "recall_closure_only": round(hit_closure / opp, 3) if opp else None,
        "revisits_closed": hit_closure,
        "revisits_map_connected": hit_connected,
        "revisits_in_cooldown": hit_cooldown,
        "revisit_opportunities": opp,
        "verify_rejections": system._loop.n_verify_rejects,
    }
    out["score_sweep"] = {
        str(t): {"tp": sum(1 for e in events if e[4] and e[3] >= t),
                 "fp": sum(1 for e in events if not e[4] and e[3] >= t)}
        for t in sweep}
    return out


def _warm_closure_chain(system, cfg, dev) -> None:
    """Run the closure chain once before a timed region, so the first
    timed closure measures execution (PyTorch compiles nothing, but the
    first call of each op on the card loads its kernels and the
    libraries' handles).  Verification and PGO run on copies of the map
    and of the pose-graph edges, whose results are dropped, as JAX drops
    its warm-up `_close`; fusion runs on the map itself, as in JAX."""
    from modular_slam_tpu_torch.map.lifecycle import fuse_duplicate_landmarks

    lp = system._loop
    warm = prng_key(0)                # leaves the system's key alone
    k = cfg.loop.top_k
    lp._verify_slots(_clone(system.arena),
                     torch.zeros((k,), dtype=torch.float32, device=dev),
                     torch.zeros((k,), dtype=torch.int32, device=dev),
                     system.last_features, warm)
    edges = _clone(lp.edges)
    lp._close(_clone(system.arena), 0, 0,
              torch.tensor([1.0, 0, 0, 0], device=dev),
              torch.zeros((3,), device=dev), lp._n_edges,
              _clone(system.state.pose))
    lp.edges = edges
    m = cfg.map
    system.arena, _ = fuse_duplicate_landmarks(
        system.arena, 0, 0, max_dist=m.fusion_max_dist_m,
        max_hamming=m.fusion_max_hamming)
    _sync(dev)


def bench_loop(_cfg_unused, flagship=False, *, device="cuda",
               sampler=None) -> dict:
    """Loop-closure latency on a trajectory that verifiably CLOSES loops
    (the tests' noisy-depth revisit; the bench's forward sweep never
    revisits): the full pipeline (BoW query + verify + PGO + tier-compacted
    global BA on every verified closure), reporting wall ms per
    closure-handling keyframe event WITH a per-stage breakdown
    (bow/query/verify/pgo/global-BA/fusion) and precision/recall against
    the synthetic ground truth.  `flagship=True` runs the 640x480 /
    256-kf / 16k-lm / 131k-obs capacity point; otherwise four laps at
    320x240."""
    from modular_slam_tpu_torch.backend.ba import global_ba_tier
    from modular_slam_tpu_torch.config import (BackendConfig, CameraConfig,
                                               DetectorConfig, LoopConfig,
                                               MapConfig, PnpConfig,
                                               SlamConfig, TrackerConfig)
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.models.pipelines import full_slam_pipeline

    dev = _resolve_device(device)
    if flagship:
        cfg = SlamConfig(
            map=MapConfig(max_keyframes=256, max_landmarks=16384,
                          max_observations=131072),
            # near-every-frame keyframes drive the solve into the big
            # compaction tiers; the temporal gap spans most of a lap so
            # only genuine lap-to-lap revisits count as candidates
            tracker=TrackerConfig(new_keyframe_min_inliers=300),
            loop=LoopConfig(min_gap_keyframes=32, min_score=0.05,
                            min_inliers=25, global_ba_on_loop=True),
        )
        gen = PlaneSceneGenerator(cfg.camera, seed=3, depth_noise=0.03)
        poses = gen.loop_trajectory(48, radius=1.2) * 2    # 2 laps, 640x480
    else:
        cfg = SlamConfig(
            camera=CameraConfig(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                                width=320, height=240),
            detector=DetectorConfig(n_levels=4, max_keypoints=384),
            map=MapConfig(max_keyframes=64, max_landmarks=8192,
                          max_observations=32768),
            pnp=PnpConfig(n_hypotheses=64),
            backend=BackendConfig(max_iterations=8),
            loop=LoopConfig(min_gap_keyframes=4, min_score=0.05,
                            min_inliers=25, global_ba_on_loop=True),
        )
        gen = PlaneSceneGenerator(cfg.camera, seed=3, depth_noise=0.03)
        poses = gen.loop_trajectory(24, radius=1.2) * 4    # 4 laps
    frames = [(rgb, depth, ts) for rgb, depth, ts in gen.sequence(poses)]
    grays, depths, _ = _stage_frames(frames, device=dev)
    tss = [ts for _, _, ts in frames]
    end = len(frames) - (len(frames) % CHUNK)

    def _one_pass(profile: bool, gba_tiers=None):
        """One full run.  `profile=False` measures the TRUE per-closure
        wall time (one sync at the event's end); `profile=True` also syncs
        after every stage for the breakdown, so its event totals must
        never be quoted as the closure latency."""
        system = full_slam_pipeline(cfg, ba_mode="sync", device=dev,
                                    sampler=sampler)
        lp = system._loop
        lp.profile = profile
        if gba_tiers is not None:
            lp._gba_tiers.update(gba_tiers)
        system.process_chunk_device(grays[:CHUNK], depths[:CHUNK],
                                    tss[:CHUNK])
        _sync(dev)
        system.process(*frames[CHUNK])
        _warm_closure_chain(system, cfg, dev)
        system.arena, _ = lp._run_global_ba(
            system.arena, system.state, max(system.n_keyframes - 1, 0))
        # one global BA at each of the NEXT compaction tiers the growing
        # map will reach (2x/4x each dim, capped at capacity), on a copy
        # of the map, where JAX compiles them
        t0_ = global_ba_tier(system.arena)
        m = cfg.map
        warm_tiers = {t0_}
        # landmark/observation counts grow faster than keyframes, so
        # cover per-dimension growth combinations, not just uniform ones
        for fk, fl, fo in ((1, 2, 1), (1, 4, 1), (1, 2, 2), (1, 4, 4),
                           (2, 2, 2), (2, 4, 4), (4, 4, 4)):
            warm_tiers.add((min(t0_[0] * fk, m.max_keyframes),
                            min(t0_[1] * fl, m.max_landmarks),
                            min(t0_[2] * fo, m.max_observations)))
        for tier in sorted(warm_tiers - set(lp._gba_tiers)):
            lp._gba_for(tier)(_clone(system.arena))
        _sync(dev)
        lp._gba_pending = False
        gba_warm = lp.n_global_ba
        # warm-up keyframes polluted the profile/event logs: reset
        lp.stage_ms = {k: [] for k in lp.stage_ms}
        lp.closures = []
        lp.n_verify_rejects = 0

        orig = lp.on_new_keyframe
        closure_times = []

        def timed_loop(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            _sync(dev)
            dt = time.perf_counter() - t0
            if out[2]:
                closure_times.append(dt)
            return out

        lp.on_new_keyframe = timed_loop
        for lo in range(CHUNK, end, CHUNK):
            system.process_chunk_device(
                grays[lo:lo + CHUNK], depths[lo:lo + CHUNK],
                tss[lo:lo + CHUNK])
        _sync(dev)
        return system, closure_times, gba_warm

    # pass 1: unprofiled -> authoritative closure latency
    system, closure_times, gba_warmup_runs = _one_pass(profile=False)
    # pass 2: profiled -> per-stage breakdown (inflated totals)
    system_p, _, _ = _one_pass(profile=True,
                               gba_tiers=system._loop._gba_tiers)

    out = {
        "n_loop_closures": system.n_loop_closures,
        "n_keyframes": system.n_keyframes,
        "global_ba_runs": system._loop.n_global_ba - gba_warmup_runs,
        "capacity": (f"{cfg.camera.width}x{cfg.camera.height}, "
                     f"kf={cfg.map.max_keyframes}, "
                     f"lm={cfg.map.max_landmarks}, "
                     f"obs={cfg.map.max_observations}"),
    }
    if closure_times:
        out["closure_ms_median"] = round(
            1e3 * statistics.median(closure_times), 1)
        out["closure_ms_mean"] = round(
            1e3 * sum(closure_times) / len(closure_times), 1)
        out["closure_ms_max"] = round(1e3 * max(closure_times), 1)
    out["gba_tiers_visited"] = [list(t) for t in
                                sorted(system._loop._gba_tiers)]
    # per-stage breakdown from the PROFILED pass (each stage's number
    # includes its own device sync; 'bow'/'query' run on every keyframe,
    # the rest only on closure events)
    out["stage_ms_median_profiled"] = {
        k: round(statistics.median(v), 1)
        for k, v in system_p._loop.stage_ms.items() if v}
    out["stage_ms_max_profiled"] = {
        k: round(max(v), 1)
        for k, v in system_p._loop.stage_ms.items() if v}

    # --- OVERLAPPED closure handling: the deferred-pipelined mode parks
    # verifications and resolves them at the next chunk's entry, so
    # closure handling should cost far less than the synchronous latency
    # above; measured as the wall-time delta of the whole pipelined run
    # with closures on vs off, per closure
    def _deferred_wall(enable_loop: bool):
        sysd = full_slam_pipeline(cfg, ba_mode="sync", defer_chunk_sync=True,
                                  device=dev, sampler=sampler)
        sysd.enable_loop_closure = enable_loop
        lpd = sysd._loop
        lpd._gba_tiers.update(system._loop._gba_tiers)
        sysd.process_chunk_device(grays[:CHUNK], depths[:CHUNK],
                                  tss[:CHUNK])
        _sync(dev)
        sysd.process(*frames[CHUNK])
        _warm_closure_chain(sysd, cfg, dev)
        lpd._gba_pending = False
        t0 = time.perf_counter()
        for lo in range(2 * CHUNK, end, CHUNK):
            sysd.process_chunk_device(
                grays[lo:lo + CHUNK], depths[lo:lo + CHUNK],
                tss[lo:lo + CHUNK])
        sysd.flush_backend()
        _sync(dev)
        return time.perf_counter() - t0, sysd.n_loop_closures

    w_on, n_cl = _deferred_wall(True)
    w_off, _ = _deferred_wall(False)
    out["deferred_overlap"] = {
        "wall_s_loop_on": round(w_on, 3),
        "wall_s_loop_off": round(w_off, 3),
        "closures": n_cl,
        "added_ms_per_closure": round(
            1e3 * max(w_on - w_off, 0.0) / max(n_cl, 1), 1),
    }

    # score with the EFFECTIVE adaptive gap (loop/detector.py), not the cap
    n_live = int(system.arena.kf_valid.sum())
    eff_gap = int(np.clip(round(cfg.loop.min_gap_fraction * n_live),
                          cfg.loop.min_gap_floor,
                          cfg.loop.min_gap_keyframes))
    out["accuracy"] = _score_closures(system, poses, eff_gap)
    out["accuracy"]["effective_min_gap"] = eff_gap
    print(f"loop bench: {out}", file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# host-CPU proxy baseline (a copy of bench.py's)
# ---------------------------------------------------------------------------


def _rodrigues(rvec):
    import cv2

    return cv2.Rodrigues(np.asarray(rvec, np.float64))[0]


def _numpy_local_ba(kf_poses, points, obs, fixed0=True, iters=10,
                    lm_lambda=1e-4):
    """Dense-Schur Levenberg-Marquardt local BA — the CPU proxy for the
    reference's intended CeresBackend local solve (ceres_backend.cpp:
    point-to-point residual :40-44, local window :162-171, <=100 iters).

    kf_poses: list of (R_cw [3,3], t_cw [3]) camera-from-world
    points:   [L, 3] world landmarks (optimized)
    obs:      list of (k, l, x_cam [3]) depth-backprojected measurements
    Returns (kf_poses, points, final_cost).
    """
    K, L = len(kf_poses), len(points)
    R = np.stack([p[0] for p in kf_poses])
    t = np.stack([p[1] for p in kf_poses])
    X = points.copy()
    ks = np.array([o[0] for o in obs])
    ls = np.array([o[1] for o in obs])
    meas = np.stack([o[2] for o in obs])
    lam = lm_lambda

    def cost(R, t, X):
        pc = np.einsum("oij,oj->oi", R[ks], X[ls]) + t[ks]
        return 0.5 * np.sum((pc - meas) ** 2)

    c_prev = cost(R, t, X)
    for _ in range(iters):
        pc = np.einsum("oij,oj->oi", R[ks], X[ls]) + t[ks]
        r = pc - meas                                   # [O, 3]
        # jacobians per obs: pose (w, dt) and landmark
        Jp = np.zeros((len(obs), 3, 6))
        rx = np.einsum("oij,oj->oi", R[ks], X[ls])      # rotated point
        Jp[:, 0, 1], Jp[:, 0, 2] = rx[:, 2], -rx[:, 1]  # -[rx]_x
        Jp[:, 1, 0], Jp[:, 1, 2] = -rx[:, 2], rx[:, 0]
        Jp[:, 2, 0], Jp[:, 2, 1] = rx[:, 1], -rx[:, 0]
        Jp[:, :, 3:] = np.eye(3)
        Jl = R[ks]                                      # [O, 3, 3]

        U = np.zeros((K, 6, 6))
        V = np.zeros((L, 3, 3))
        W = np.zeros((K, L, 6, 3))
        gp = np.zeros((K, 6))
        gl = np.zeros((L, 3))
        np.add.at(U, ks, np.einsum("oai,oaj->oij", Jp, Jp))
        np.add.at(V, ls, np.einsum("oai,oaj->oij", Jl, Jl))
        np.add.at(W, (ks, ls), np.einsum("oai,oaj->oij", Jp, Jl))
        np.add.at(gp, ks, np.einsum("oai,oa->oi", Jp, r))
        np.add.at(gl, ls, np.einsum("oai,oa->oi", Jl, r))

        U += lam * np.eye(6)
        V += lam * np.eye(3)
        Vinv = np.linalg.inv(V)
        # reduced camera system S dx = rhs
        S = np.zeros((K * 6, K * 6))
        for a in range(K):
            S[a * 6:(a + 1) * 6, a * 6:(a + 1) * 6] = U[a]
        WVi = np.einsum("klij,ljm->klim", W, Vinv)      # [K, L, 6, 3]
        S -= np.einsum("alim,bljm->abij", WVi, W).transpose(
            0, 2, 1, 3).reshape(K * 6, K * 6)
        rhs = -(gp - np.einsum("klim,lm->ki", WVi, gl)).reshape(-1)
        if fixed0:  # gauge: oldest keyframe fixed (ceres_backend.cpp:155-159)
            S[:6, :] = 0.0
            S[:, :6] = 0.0
            S[:6, :6] = np.eye(6)
            rhs[:6] = 0.0
        try:
            dxp = np.linalg.solve(S, rhs).reshape(K, 6)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        dxl = -np.einsum("lij,lj->li", Vinv,
                         gl + np.einsum("klim,ki->lm", W, dxp))

        R_new = np.stack([_rodrigues(dxp[a, :3]) @ R[a] for a in range(K)])
        t_new = t + dxp[:, 3:]
        X_new = X + dxl
        c_new = cost(R_new, t_new, X_new)
        if c_new < c_prev:
            R, t, X, c_prev = R_new, t_new, X_new, c_new
            lam = max(lam * 0.3, 1e-9)
        else:
            lam *= 10
    return [(R[a], t[a]) for a in range(K)], X, c_prev


def _gt_rows(poses):
    gt = np.zeros((len(poses), 8))
    for k, p in enumerate(poses):
        gt[k, 0] = k / 30.0
        gt[k, 1:4] = np.asarray(p.t)
        q = np.asarray(p.q)
        gt[k, 4:7], gt[k, 7] = q[1:4], q[0]
    return gt


def bench_opencv_baseline(cfg, frames, with_ba: bool, collect_traj=None):
    """The reference's per-frame hot path via OpenCV on the host CPU, with
    the reference's keyframe rule (inliers < 30 -> new keyframe,
    rgbd_feature_frontend.cpp:156-162) and, when with_ba, the proxy local
    BA per keyframe.  Raises ImportError where OpenCV is not installed."""
    import cv2

    cam = cfg.camera
    Kmat = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                    np.float32)
    orb = cv2.ORB_create(1000)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING)
    grays = [cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) for rgb, _, _ in frames]

    def backproject(kps, descs, depth, R_wc, t_wc):
        pts_w, pts_c, good_desc, pix = [], [], [], []
        for k, d in zip(kps, descs):
            u, v = int(round(k.pt[0])), int(round(k.pt[1]))
            z = float(depth[min(v, depth.shape[0] - 1),
                            min(u, depth.shape[1] - 1)])
            if z > 0:
                pc = np.array([(k.pt[0] - cam.cx) * z / cam.fx,
                               (k.pt[1] - cam.cy) * z / cam.fy, z])
                pts_c.append(pc)
                pts_w.append(R_wc @ pc + t_wc)
                good_desc.append(d)
                pix.append(k.pt)
        return (np.array(pts_w, np.float32), np.array(pts_c, np.float64),
                np.array(good_desc), np.array(pix, np.float32))

    t0 = time.perf_counter()
    # bootstrap keyframe at identity
    kp0, des0 = orb.detectAndCompute(grays[0], None)
    I, z3 = np.eye(3), np.zeros(3)
    pts_w, pts_c, desc_ref, _ = backproject(kp0, des0, frames[0][1], I, z3)
    keyframes = [{"R_cw": I.copy(), "t_cw": z3.copy(),
                  "pts_w_idx": np.arange(len(pts_w)), "pts_c": pts_c}]
    world_pts = list(pts_w)
    rvec, tvec = np.zeros((3, 1)), np.zeros((3, 1))
    n, n_kf, ba_ms = 0, 1, 0.0

    for fi in range(WARMUP, len(frames)):
        gray, depth = grays[fi], frames[fi][1]
        kp, des = orb.detectAndCompute(gray, None)
        if des is None or len(des) < 10:
            continue
        matches = bf.knnMatch(des, desc_ref, k=2)
        good = [m for m, s in (p for p in matches if len(p) == 2)
                if m.distance < 0.7 * s.distance]
        n += 1
        if len(good) < 10:
            continue
        obj = pts_w[[m.trainIdx for m in good]]
        img = np.array([kp[m.queryIdx].pt for m in good], np.float32)
        okp, rvec, tvec, inl = cv2.solvePnPRansac(
            obj, img, Kmat, None, rvec=rvec, tvec=tvec,
            useExtrinsicGuess=True, iterationsCount=100,
            reprojectionError=5.0, confidence=0.99)
        n_inl = 0 if inl is None else len(inl)
        if collect_traj is not None and okp:
            Rcw = _rodrigues(rvec.ravel())
            tw = -Rcw.T @ tvec.ravel()
            collect_traj.append((frames[fi][2], Rcw.T, tw))
        if okp and n_inl < 30:  # reference keyframe rule
            R_cw = _rodrigues(rvec.ravel())
            t_cw = tvec.ravel()
            R_wc, t_wc = R_cw.T, -R_cw.T @ t_cw
            pts_w, pts_c, desc_ref, _ = backproject(
                kp, des, depth, R_wc, t_wc)
            base = len(world_pts)
            world_pts.extend(pts_w)
            keyframes.append({
                "R_cw": R_cw, "t_cw": t_cw,
                "pts_w_idx": np.arange(base, base + len(pts_w)),
                "pts_c": pts_c})
            n_kf += 1
            if with_ba:
                tb = time.perf_counter()
                win = keyframes[-BA_WINDOW:]
                lm_ids = np.concatenate([k["pts_w_idx"] for k in win])
                id_map = {g: i for i, g in enumerate(lm_ids)}
                X = np.array([world_pts[g] for g in lm_ids], np.float64)
                obs = []
                for a, kfr in enumerate(win):
                    for g, pc in zip(kfr["pts_w_idx"], kfr["pts_c"]):
                        obs.append((a, id_map[g], pc))
                poses = [(k["R_cw"], k["t_cw"]) for k in win]
                poses, X, _ = _numpy_local_ba(poses, X, obs)
                for a, kfr in enumerate(win):
                    kfr["R_cw"], kfr["t_cw"] = poses[a]
                for i, g in enumerate(lm_ids):
                    world_pts[g] = X[i]
                ba_ms += (time.perf_counter() - tb) * 1e3
    dt = time.perf_counter() - t0
    tag = "track+BA" if with_ba else "tracking"
    print(f"opencv proxy {tag}: {n} frames in {dt:.3f}s, {n_kf} keyframes, "
          f"BA total {ba_ms:.1f}ms", file=sys.stderr)
    return n / dt


def _live_proxy(cfg, frames, with_ba: bool, collect_traj=None):
    """`bench_opencv_baseline`, or None where OpenCV is not installed."""
    try:
        return bench_opencv_baseline(cfg, frames, with_ba, collect_traj)
    except ImportError:
        return None


def _load_pinned_baseline():
    """BASELINE_PROXY.json (`tools/pin_baseline.py`): the median-of-N pinned
    proxy numbers, a stable denominator across runs, measured on the host
    the file names."""
    p = os.path.join(_REPO, "BASELINE_PROXY.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def _ratio(a, b):
    return None if a is None or not b else round(a / b, 3)


def _round(x, nd=3):
    return None if x is None else round(x, nd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mslam-torch-bench",
        description="The port's throughput benchmark on bench.py's "
                    "workload; one JSON line last.")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    dev = _resolve_device(args.device)

    to_build = _libraries_to_build() if dev.type == "cuda" else []
    gpu = _card(dev)
    cfg, frames, gt_poses = _sequence("plane")
    print(f"device: {dev} ({gpu})", file=sys.stderr)

    startup_s = bench_startup(cfg, frames, device=dev)
    track_detail = {}
    fps_track = bench_ours_tracking(cfg, frames, device=dev,
                                    detail=track_detail)
    fps_full, n_kf, n_ok, sys_full = bench_ours_full(
        cfg, frames, mode="pipelined", device=dev)
    fps_sync, _, _, _ = bench_ours_full(cfg, frames, mode="sync", device=dev)
    # the CPU-offload async executor against inline-sync BA under the same
    # deferred-pipelined chunking
    fps_async, _, _, _ = bench_ours_full(cfg, frames, mode="pipelined",
                                         ba_mode="async", device=dev)
    stages = bench_stages(cfg, frames, device=dev)
    proxy_traj = []
    base_track_live = _live_proxy(cfg, frames, with_ba=False,
                                  collect_traj=proxy_traj)
    base_full_live = _live_proxy(cfg, frames, with_ba=True)

    # second scenario: box world (occlusion + depth discontinuities)
    cfg_b, frames_b, _ = _sequence("box")
    fps_box, n_kf_box, ok_box, _ = bench_ours_full(
        cfg_b, frames_b, mode="pipelined", device=dev)
    base_box_live = _live_proxy(cfg_b, frames_b, with_ba=True)
    baseline_live = ("cv2 absent" if base_full_live is None
                     else "measured on this host")

    # the classical-baseline accuracy row: the proxy's own trajectory
    # against exact ground truth, next to ours
    from modular_slam_tpu_torch.eval.ate import ate_rmse

    gt_rows = _gt_rows(gt_poses)
    accuracy = {}
    try:
        accuracy["ours_ate_rmse_m"] = round(
            ate_rmse(_trajectory_rows(sys_full), gt_rows)["rmse"], 4)
    except ValueError as e:
        accuracy["ours_ate_error"] = str(e)
    if proxy_traj:
        try:
            est_proxy = np.array([
                [ts, t[0], t[1], t[2], 0.0, 0.0, 0.0, 1.0]
                for ts, _R, t in proxy_traj])
            accuracy["classical_proxy_ate_rmse_m"] = round(
                ate_rmse(est_proxy, gt_rows)["rmse"], 4)
            accuracy["classical_proxy_frames"] = len(proxy_traj)
        except ValueError as e:
            accuracy["classical_proxy_ate_error"] = str(e)

    degraded = bench_degraded(device=dev)
    loop_stats = bench_loop(cfg, device=dev)
    loop_flagship = bench_loop(cfg, flagship=True, device=dev)

    pinned = _load_pinned_baseline()
    if pinned is not None:
        base_track = pinned["tracking_fps"]
        base_full = pinned["tracking_ba_fps"]
        base_box = pinned["box_tracking_ba_fps"]
        base_note = ("host-CPU proxy (PINNED median-of-%d, "
                     "BASELINE_PROXY.json %s, measured on host %r, not this "
                     "card's host): OpenCV ORB+BF+solvePnPRansac (+ numpy "
                     "Schur-LM local BA per keyframe)"
                     % (pinned["n_runs"], pinned["pinned_at"],
                        pinned.get("host")))
    else:
        base_track, base_full, base_box = (base_track_live, base_full_live,
                                           base_box_live)
        base_note = ("host-CPU proxy (LIVE, unpinned): OpenCV "
                     "ORB+BF+solvePnPRansac (+ numpy Schur-LM local BA)")

    detail = {
        "metric": "tracking_ba_frames_per_s_per_chip",
        "value": round(fps_full, 3),
        "unit": "frames/s",
        "vs_baseline": _ratio(fps_full, base_full),
        "gpu": gpu,
        "device": str(dev),
        "ba_mode": "deferred-pipelined: host bookkeeping + BA dispatch "
                   "overlap the next chunk's device execution",
        "tracking_ba_sync_fps": round(fps_sync, 3),
        "tracking_ba_async_offload_fps": round(fps_async, 3),
        "tracking_frames_per_s_per_chip": round(fps_track, 3),
        "tracking_vs_baseline": _ratio(fps_track, base_track),
        "tracking_chunks": track_detail,
        "baseline": base_note,
        "baseline_live": baseline_live,
        "baseline_tracking_fps": _round(base_track),
        "baseline_tracking_ba_fps": _round(base_full),
        "baseline_tracking_fps_live": _round(base_track_live),
        "baseline_tracking_ba_fps_live": _round(base_full_live),
        "stage_ms": stages,
        "box_world": {
            "tracking_ba_fps": round(fps_box, 3),
            "vs_baseline": _ratio(fps_box, base_box),
            "baseline_tracking_ba_fps": _round(base_box),
            "baseline_tracking_ba_fps_live": _round(base_box_live),
            "n_keyframes": int(n_kf_box),
            "tracked_ok": int(ok_box),
        },
        "accuracy_plane_world": accuracy,
        "degraded_world": degraded,
        "loop_closure": loop_stats,
        "loop_closure_flagship": loop_flagship,
        "startup_s": round(startup_s, 1),
        "startup_nvcc_ran": bool(to_build),
        "startup_kernels_built": to_build,
        "n_keyframes": int(n_kf),
        "tracked_ok": int(n_ok),
        "n_frames": len(frames),
    }

    # the full detail goes to a FILE; the last stdout line is a compact
    # headline (< 1.5 kB) that names it
    detail_path = os.path.join(_REPO, DETAIL)
    os.makedirs(os.path.dirname(detail_path), exist_ok=True)
    with open(detail_path, "w") as f:
        json.dump(detail, f, indent=2)
    print(f"detail written to {detail_path}", file=sys.stderr)

    def _acc(d, k):
        return d.get("accuracy", {}).get(k) if d else None

    headline = {
        "metric": "tracking_ba_frames_per_s_per_chip",
        "value": round(fps_full, 3),
        "unit": "frames/s",
        "vs_baseline": _ratio(fps_full, base_full),
        "tracking_fps": round(fps_track, 3),
        "tracking_vs_baseline": _ratio(fps_track, base_track),
        "sync_fps": round(fps_sync, 3),
        "box_fps": round(fps_box, 3),
        "box_vs_baseline": _ratio(fps_box, base_box),
        "degraded_fps": degraded.get("tracking_ba_fps"),
        "degraded_ate_m": degraded.get("ate_rmse_m"),
        "ours_ate_m": accuracy.get("ours_ate_rmse_m"),
        "classical_proxy_ate_m": accuracy.get("classical_proxy_ate_rmse_m"),
        "closure_ms_median": loop_stats.get("closure_ms_median"),
        "closure_ms_max": loop_stats.get("closure_ms_max"),
        "closure_overlap_added_ms": loop_stats.get(
            "deferred_overlap", {}).get("added_ms_per_closure"),
        "closure_recall": _acc(loop_stats, "recall"),
        "closure_episode_recall": _acc(loop_stats, "episode_recall"),
        "closure_fp": _acc(loop_stats, "false_positives"),
        "flagship_closure_ms_median":
            loop_flagship.get("closure_ms_median"),
        "flagship_closure_ms_max": loop_flagship.get("closure_ms_max"),
        "flagship_recall": _acc(loop_flagship, "recall"),
        "flagship_fp": _acc(loop_flagship, "false_positives"),
        "stage_ms_detect": stages.get("detect_in_step_ms"),
        "stage_ms_track": stages.get("track_only_ms"),
        "baseline_fps": _round(base_full),
        "baseline_kind": "pinned-proxy" if pinned is not None else "live",
        "startup_warm_s": round(startup_s, 1),
        "detail": DETAIL,
        "gpu": gpu,
    }
    line = json.dumps(headline)
    if len(line) >= 1500:
        # never lose the whole run's record to a format overflow (the last
        # line is what a reader parses): drop optional fields, in
        # bench.py's order, until the headline fits
        for k in ("flagship_fp", "closure_fp", "stage_ms_detect",
                  "stage_ms_track", "sync_fps", "degraded_ate_m",
                  "box_vs_baseline", "startup_warm_s"):
            headline.pop(k, None)
            line = json.dumps(headline)
            if len(line) < 1500:
                break
        if len(line) >= 1500:  # last resort: the four core fields + gpu
            line = json.dumps({k: headline[k] for k in
                               ("metric", "value", "unit", "vs_baseline",
                                "gpu")})
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
