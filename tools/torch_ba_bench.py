#!/usr/bin/env python3
"""Profile the port's local BA on a map built by tracking (counterpart of
tools/ba_bench.py).

Builds the arena of 48 frames of `bench.py`'s sequence through
`make_slam_scan` (the map `tools/ba_bench.py:39` builds), then times the
full `make_local_ba` call on the last keyframe's window, compaction only
(`extract_window`), and the dense LM core (`ba_core_dense`) at 1, 2, 5 and
10 iterations: each the mean over several calls between CUDA events after
a warm-up call.  `make_local_ba` updates the arena in place, so each of
its calls gets a copy of the map made before the timed region.

    python tools/torch_ba_bench.py [--device cuda] [--tiny]

Prints the JAX tool's lines, then one JSON object of them.  `--device`
defaults to "cuda" and raises without a CUDA device; `--tiny`
runs `tiny_test_config()` on 12 frames (a smoke run whose numbers mean
nothing).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def build_arena(cfg, n_frames=48, *, device="cuda", texture_ppm=400.0,
                step_scale=1.0):
    """The tracked map of n_frames of bench.py's trajectory (seed 42):
    -> (arena, state, the last keyframe's slot)."""
    import torch

    from modular_slam_tpu_torch import bench
    from modular_slam_tpu_torch.engine import _resolve_device, make_slam_scan
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.frontend.tracker import initial_state
    from modular_slam_tpu_torch.map.arena import empty_arena
    from modular_slam_tpu_torch.utils.prng import prng_key, split

    dev = _resolve_device(device)
    gen = PlaneSceneGenerator(cfg.camera, seed=42, texture_ppm=texture_ppm)
    poses = gen.trajectory(
        n_frames, step_t=tuple(step_scale * x for x in (0.05, 0.02, 0.01)),
        step_rot=tuple(step_scale * x for x in (0.004, 0.008, 0.004)))
    frames = list(gen.sequence(poses))
    grays, depths, times = bench._stage_frames(frames, device=dev)
    scan = make_slam_scan(cfg, device=dev)
    arena, state, res = scan(empty_arena(cfg.map, dev), initial_state(dev),
                             grays, depths, times,
                             split(prng_key(0), len(frames)), bootstrap=True)
    kf_slots = res.kf_slot.cpu().numpy()
    new_kf = res.new_keyframe.cpu().numpy()
    last_kf = int(kf_slots[np.nonzero(new_kf)[0][-1]])
    n_kf, n_lm, n_obs = (int(x) for x in torch.stack(
        [arena.n_kf, arena.n_lm, arena.n_obs]).cpu())
    print(f"arena: {n_kf} kf, {n_lm} lm, {n_obs} obs; last kf_slot="
          f"{last_kf}", file=sys.stderr)
    return arena, state, last_kf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_test_config() on 12 frames (a smoke run)")
    args = ap.parse_args(argv)

    from modular_slam_tpu_torch import bench
    from modular_slam_tpu_torch.backend.ba import (ba_core_dense,
                                                   extract_window,
                                                   local_ba_config,
                                                   make_local_ba)
    from modular_slam_tpu_torch.config import SlamConfig, tiny_test_config
    from modular_slam_tpu_torch.engine import _resolve_device
    from modular_slam_tpu_torch.geometry.camera import camera_from_config

    dev = _resolve_device(args.device)
    print(f"device: {dev} ({bench._card(dev)})", file=sys.stderr)
    if args.tiny:
        cfg = tiny_test_config()
        arena, state, slot = build_arena(cfg, 12, device=dev,
                                         texture_ppm=100.0, step_scale=0.1)
    else:
        cfg = SlamConfig()
        arena, state, slot = build_arena(cfg, device=dev)
    out = {}

    def timeit(label, fn, n=20, prepare=lambda: None):
        """Mean ms of fn(prepare()) over n calls after a warm-up call."""
        fn(prepare())
        args_ = [prepare() for _ in range(n)]
        bench._sync(dev)

        def run():
            for a in args_:
                fn(a)

        out[label] = bench._region_ms(run, dev) / n
        print(f"{label}: {out[label]:.2f} ms", flush=True)

    # --- full local BA, each call on a copy of the map --------------------
    ba = make_local_ba(cfg, device=dev)
    timeit("local_ba total", lambda a: ba(a, state, slot),
           prepare=lambda: bench._clone(arena))

    # --- compaction only (the real extract_window) -------------------------
    cam = camera_from_config(cfg.camera, dev)
    bcfg = local_ba_config(cfg)
    timeit("compact only", lambda _: extract_window(cam, arena, slot, bcfg))

    p = extract_window(cam, arena, slot, bcfg)
    print(f"window: {int(p.pose_free.sum()) + 1} kf, {int(p.lm_ok.sum())} "
          f"lm, {int((p.obs.w > 0).sum())} obs", file=sys.stderr)

    # --- dense core at various iteration counts ----------------------------
    for iters in (1, 2, 5, 10):
        b = dataclasses.replace(bcfg, max_iterations=iters)
        timeit(f"dense core {iters:2d} iters",
               lambda _, b=b: ba_core_dense(
                   cam, p.kf_q, p.kf_t, p.lm_pos, p.obs, p.pose_free,
                   p.lm_ok, b, residual_type=bcfg.local_residual), n=10)
    print(json.dumps({"ms": out, "device": str(dev),
                      "gpu": bench._card(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
