#!/usr/bin/env python3
"""Per-op probes of the port over DIFFERENT per-frame inputs (counterpart
of tools/scan_bench.py).

Each op runs in a loop over n random frames (or n random query sets) with
no host read inside, timed between CUDA events around the loop after a
warm-up run, divided by n; every output is consumed.  As the JAX tool's
`lax.scan`, this times what the engine pays for the op on varying inputs,
not a replay of one input.

    python tools/torch_scan_bench.py [--probe detect|match|all] [--n 12]
        [--device cuda] [--tiny]

The detect probes: full `detect`, the pyramid, pyramid + FAST (K1, all
levels in one launch, as the detector calls it) + 3x3 NMS, pyramid +
blur, pyramid + moments.  The match probes, at the tracker's shape (the
detector's keypoint budget against the whole landmark pool, 10 % of it
invalid), with and without `dedupe_matches`: the plain PyTorch matcher
(JAX's "XLA" line; a yardstick, which the engine never runs on the card)
and K2 with its merge (JAX's "Pallas" line; on the card only).  One line
per probe as the JAX tool prints it, then one JSON object of them.
`--device` defaults to "cuda" and raises without a CUDA device; `--tiny`
runs `tiny_test_config()` (a smoke run whose numbers mean nothing).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", default="all",
                    choices=["detect", "match", "all"])
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_test_config() (a smoke run)")
    args = ap.parse_args(argv)

    import torch

    from modular_slam_tpu_torch import bench
    from modular_slam_tpu_torch.config import SlamConfig, tiny_test_config
    from modular_slam_tpu_torch.engine import _resolve_device

    dev = _resolve_device(args.device)
    cfg = tiny_test_config() if args.tiny else SlamConfig()
    dcfg = cfg.detector
    n = args.n
    H, W = cfg.camera.height, cfg.camera.width
    rng = np.random.default_rng(0)
    grays = torch.as_tensor(rng.uniform(0, 255, (n, H, W)).astype(
        np.float32), device=dev)
    depths = torch.as_tensor(rng.uniform(0.5, 2.5, (n, H, W)).astype(
        np.float32), device=dev)
    print(f"device: {dev} ({bench._card(dev)})", flush=True)
    ms, busy = {}, {}

    def scan_probe(body, xs, label):
        """body(per-step slices...) -> scalar; xs: tuple of [n, ...]."""
        def run():
            c = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                c = c + body(*(x[i] for x in xs))
            return c

        run()
        bench._sync(dev)
        ms[label] = bench._region_ms(run, dev) / n
        busy[label] = bench._profiled(run, dev, n)[0]
        print(f"{label:28s} {ms[label]:7.3f} ms/frame", flush=True)

    if args.probe in ("detect", "all"):
        from modular_slam_tpu_torch.ops import blur, fast, orient, pyramid
        from modular_slam_tpu_torch.ops.detector import detect

        scan_probe(lambda g, d: detect(g, d, dcfg).keypoints.response.sum(),
                   (grays, depths), "detect (full)")
        scan_probe(
            lambda g, d: sum(l.sum() for l in pyramid.build_pyramid(g, dcfg)),
            (grays, depths), "pyramid")

        def fast_all(g, d):
            levels = pyramid.build_pyramid(g, dcfg)
            return sum(fast.nms3x3(s).sum()
                       for s in fast.fast_score_levels(levels))
        scan_probe(fast_all, (grays, depths), "pyramid+fast+nms")

        def blur_all(g, d):
            levels = pyramid.build_pyramid(g, dcfg)
            return sum(blur.gaussian_blur(l, dcfg.blur_ksize,
                                          dcfg.blur_sigma).sum()
                       for l in levels)
        scan_probe(blur_all, (grays, depths), "pyramid+blur")

        def mom_all(g, d):
            levels = pyramid.build_pyramid(g, dcfg)
            return sum(orient.moment_maps(l).sum() for l in levels)
        scan_probe(mom_all, (grays, depths), "pyramid+moments")

    if args.probe in ("match", "all"):
        from modular_slam_tpu_torch.ops.match import (dedupe_matches,
                                                      match_descriptors,
                                                      match_descriptors_plain)

        Nq, L = dcfg.max_keypoints, cfg.map.max_landmarks
        qs = torch.as_tensor(
            rng.integers(0, 2, (n, Nq, 256)).astype(np.int8) * 2 - 1,
            device=dev)
        t = torch.as_tensor(
            rng.integers(0, 2, (L, 256)).astype(np.int8) * 2 - 1, device=dev)
        qv = torch.ones((Nq,), dtype=torch.bool, device=dev)
        tv = torch.as_tensor(rng.random(L) > 0.1, device=dev)
        fns = [("plain", match_descriptors_plain)]
        if dev.type == "cuda":
            fns.append(("kernel", match_descriptors))

        for tag, fn in fns:
            scan_probe(
                lambda q, fn=fn: fn(q, qv, t, tv, cfg.matcher).distance.sum(),
                (qs,), f"match {tag} {Nq}x{L}")
        for tag, fn in fns:
            scan_probe(
                lambda q, fn=fn: dedupe_matches(
                    fn(q, qv, t, tv, cfg.matcher), L).distance.sum(),
                (qs,), f"match {tag} + dedupe")
    print(json.dumps({"ms_per_frame": ms, "device_busy_ms_per_frame": busy,
                      "device": str(dev), "gpu": bench._card(dev), "n": n}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
