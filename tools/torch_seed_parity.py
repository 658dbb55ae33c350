#!/usr/bin/env python3
"""The port from a seed against the JAX package from the same seed, at the
full size of `chip_smoke.py`'s loop runs, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_seed_parity.py [--dataset DIR]
                                                        [--skip-full]

Three runs, each printed as one JSON line:

- `cli_seed0`: the port's runner loop (`chip_smoke.run_like_runner`: full
  preset, chunks of 16 in the wire format, deferred, the tail frame by
  frame) from seed 0 with no sampler on `chip_smoke.py`'s cli dataset
  (written into DIR unless it is there), every RANSAC draw recorded and
  held against the JAX engine's draws in
  `modular_slam_tpu_torch/data/cli_jax_draws.npz`; frame and keyframe
  ATE, closures and keyframes beside the record's.
- `jax_runner_seed0`: the JAX package's runner loop on the same dataset
  as `python -m modular_slam_tpu.run` builds it (its global-BA tiers
  compiled in the background): ATE, keyframes, closures, and how many
  global BAs it deferred while a tier compiled.
- `full_phase` (unless `--skip-full`): `chip_smoke.py`'s `full` phase
  frames (the flagship loop, `chip_smoke.loop_frames`) through
  `process` on the port and on the JAX engine from seed 0, the JAX side
  with every global-BA tier up front (no deferral): closures, keyframes,
  keyframe ATE, and whether every frame's flags and inlier counts agree.

Imports both packages; runs on the CPU only (several minutes).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402


def _tum(system) -> np.ndarray:
    rows = []
    for ts, pose in system.trajectory:
        q, t = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
                for x in (pose.q, pose.t))
        rows.append([ts, *t, *q[1:], q[0]])
    return np.array(rows)


def _record_draws():
    """Wrap the port's draw so that every draw's rows land in a list."""
    from modular_slam_tpu_torch.loop import detector
    from modular_slam_tpu_torch.ops import pnp

    draws = []
    real = pnp.draw_rows

    def draw_rows(key, valid, n_hyp):
        rows = real(key, valid, n_hyp)
        draws.extend(rows.cpu().numpy().astype(np.int16).reshape(
            -1, n_hyp, 3))
        return rows

    pnp.draw_rows = detector.draw_rows = draw_rows
    return draws


def cli_runs(ds_dir: str) -> None:
    from modular_slam_tpu.config import SlamConfig as JaxSlamConfig
    from modular_slam_tpu.models import make_pipeline as jax_pipeline
    from modular_slam_tpu.run import apply_overrides as jax_overrides
    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.io.tum import TumRgbdDataset
    from modular_slam_tpu_torch.models import make_pipeline
    from modular_slam_tpu_torch.run import apply_overrides

    if not os.path.exists(os.path.join(ds_dir, "rgb.txt")):
        chip_smoke.write_cli_dataset(ds_dir)
    ds = TumRgbdDataset(ds_dir)
    rec = np.load(chip_smoke.CLI_DRAWS)
    n = int(rec["frames"])
    gt = ds.groundtruth

    draws = _record_draws()
    cfg = apply_overrides(SlamConfig().replace(camera=ds.camera),
                          chip_smoke.CLI_OVERRIDES)
    port = make_pipeline("full", cfg, device="cpu", seed=0,
                         defer_chunk_sync=True)
    t0 = time.perf_counter()
    chip_smoke.run_like_runner(port, ds, n)
    want = rec["draws"]
    same = [bool(np.array_equal(a, b)) for a, b in zip(draws, want)]
    print(json.dumps({
        "run": "cli_seed0", "frames": n, "draws": len(draws),
        "recorded_draws": len(want), "draws_equal": sum(same),
        "first_differing_draw": (same.index(False) if False in same
                                 else None),
        "ate_rmse_m": ate_rmse(_tum(port), gt, max_difference=0.05)["rmse"],
        "kf_ate_rmse_m": ate_rmse(port.keyframe_trajectory(), gt,
                                  max_difference=0.05)["rmse"],
        "loop_closures": port.n_loop_closures,
        "keyframes": port.n_keyframes,
        "jax_record": {"ate_rmse_m": float(rec["jax_ate_rmse_m"]),
                       "kf_ate_rmse_m": float(rec["jax_kf_ate_rmse_m"]),
                       "loop_closures": int(rec["jax_loop_closures"]),
                       "keyframes": int(rec["jax_keyframes"])},
        "seconds": time.perf_counter() - t0}), flush=True)

    jcfg = jax_overrides(JaxSlamConfig().replace(camera=ds.camera),
                         chip_smoke.CLI_OVERRIDES)
    jsys = jax_pipeline("full", jcfg, seed=0, defer_chunk_sync=True)
    t0 = time.perf_counter()
    chip_smoke.run_like_runner(jsys, ds, n)
    print(json.dumps({
        "run": "jax_runner_seed0", "frames": n,
        "ate_rmse_m": ate_rmse(_tum(jsys), gt, max_difference=0.05)["rmse"],
        "loop_closures": jsys.n_loop_closures,
        "keyframes": jsys.n_keyframes,
        "global_ba": jsys._loop.n_global_ba,
        "global_ba_deferred": jsys._loop.n_gba_deferred,
        "seconds": time.perf_counter() - t0}), flush=True)


def full_phase() -> None:
    from modular_slam_tpu.config import LoopConfig as JaxLoopConfig
    from modular_slam_tpu.config import MapConfig as JaxMapConfig
    from modular_slam_tpu.config import SlamConfig as JaxSlamConfig
    from modular_slam_tpu.config import TrackerConfig as JaxTrackerConfig
    from modular_slam_tpu.loop.pipeline import LoopPipeline as JaxLoop
    from modular_slam_tpu.models import make_pipeline as jax_pipeline
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.models import make_pipeline
    from tests.test_torch_engine import _EveryTier

    cfg = chip_smoke.loop_config()
    jcfg = JaxSlamConfig(
        map=JaxMapConfig(max_keyframes=256, max_landmarks=16384,
                         max_observations=131072),
        tracker=JaxTrackerConfig(new_keyframe_min_inliers=300),
        loop=JaxLoopConfig(min_gap_keyframes=32, min_score=0.05,
                           min_inliers=25, global_ba_on_loop=True))
    poses, frames = chip_smoke.loop_frames(cfg)
    gt = np.array([[f[2], *p.t, *np.asarray(p.q)[1:],
                    float(np.asarray(p.q)[0])]
                   for f, p in zip(frames, poses)])
    JaxLoop._compile_tier_async = lambda self, tier, arena: None
    JaxLoop.start_background_prewarm = lambda self, arena: None
    jsys = jax_pipeline("full", jcfg, seed=0)
    jsys._loop._gba_tiers = _EveryTier(jcfg)
    port = make_pipeline("full", cfg, device="cpu", seed=0)
    out = {"run": "full_phase", "frames": len(frames)}
    flags = {}
    for name, system in (("jax", jsys), ("port", port)):
        for f in frames:
            system.process(*f)
        system.flush_backend()
        flags[name] = [(bool(r.tracking_ok), bool(r.new_keyframe),
                        int(r.n_inliers)) for r in system.results]
        out[name] = {
            "loop_closures": system.n_loop_closures,
            "closure_pairs": [[int(x) for x in c[:2]]
                              for c in system._loop.closures],
            "keyframes": int(system.n_keyframes),
            "kf_ate_rmse_m": ate_rmse(system.keyframe_trajectory(),
                                      gt)["rmse"]}
    out["same_flags_and_inliers"] = flags["jax"] == flags["port"]
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--skip-full", action="store_true")
    args = ap.parse_args()
    cli_runs(args.dataset or os.path.join(tempfile.mkdtemp(), "loop"))
    if not args.skip_full:
        full_phase()
    return 0


if __name__ == "__main__":
    sys.exit(main())
