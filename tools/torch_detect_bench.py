#!/usr/bin/env python3
"""The port's detector substage probes (counterpart of
tools/detect_bench.py).

Splits the detect pass into pyramid / FAST (K1, all levels in one launch)
/ NMS + cell top-k / blur / moments / the `detect_until` cuts (select,
atlas, orient, brief, full) / full `detect`, each probed as
`modular_slam_tpu_torch/bench.py`'s stage probes are: a loop over 64 frames
(32 distinct frames of `bench.py`'s workload, twice) with no host read
inside, timed between CUDA events around the loop, best of 3 after a
warm-up run, divided by the count; every output is consumed.  Also the
bytes-moved lower bound of the whole pass (read the frame once, write each
product once, float32) and its time at the card's 3.35 TB/s, and each
probe's device-busy ms per frame from a profiled run.

    python tools/torch_detect_bench.py [--device cuda] [--tiny]

Prints one JSON object with `substage_ms` and `bytes_lower_bound` (the JAX
tool's keys) and `device_busy_ms_per_frame`.  `--device` defaults to
"cuda" and raises without a CUDA device; `--tiny` runs
`tiny_test_config()` on 2 distinct frames, a smoke run whose numbers mean
nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA's data sheet


def _workload(tiny: bool, dev):
    """(config, grays [n, H, W], depths [n, H, W]) on the device: 32
    frames of bench.py's sequence after its warm-up, twice over."""
    import torch

    from modular_slam_tpu_torch import bench

    if tiny:
        from modular_slam_tpu_torch.config import tiny_test_config
        from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator

        cfg_all = tiny_test_config()
        gen = PlaneSceneGenerator(cfg_all.camera, seed=42,
                                  texture_ppm=100.0)
        n0 = 2
        frames = list(gen.sequence(gen.trajectory(
            bench.WARMUP + n0, step_t=(0.005, 0.002, 0.0))))
    else:
        cfg_all, frames, _ = bench._sequence("plane")
        n0 = bench.PROBE_FRAMES
    grays0, depths0, _ = bench._stage_frames(
        frames[bench.WARMUP:bench.WARMUP + n0], device=dev)
    return (cfg_all, torch.cat([grays0, grays0]),
            torch.cat([depths0, depths0]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_test_config() on 2 frames (a smoke run)")
    args = ap.parse_args(argv)

    import torch

    from modular_slam_tpu_torch import bench
    from modular_slam_tpu_torch.engine import _resolve_device
    from modular_slam_tpu_torch.ops.blur import gaussian_blur
    from modular_slam_tpu_torch.ops.detector import (CUTS, _cell_candidates,
                                                     _cell_threshold_fallback,
                                                     _pad_to, detect,
                                                     detect_until)
    from modular_slam_tpu_torch.ops.fast import (border_mask,
                                                 fast_score_levels, nms3x3)
    from modular_slam_tpu_torch.ops.orient import moment_maps
    from modular_slam_tpu_torch.ops.pyramid import (build_pyramid,
                                                    pyramid_shapes)

    dev = _resolve_device(args.device)
    cfg_all, grays, depths = _workload(args.tiny, dev)
    cfg = cfg_all.detector
    n = grays.shape[0]
    H0, W0 = grays.shape[1:]
    print(f"device: {dev} ({bench._card(dev)})", file=sys.stderr)
    busy = {}

    def probe(name, body_fn, consume, with_depth=False):
        """ms per frame of body_fn over the n frames, best of 3 after a
        warm-up run."""
        def run():
            c = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n):
                args_ = (grays[i], depths[i]) if with_depth else (grays[i],)
                c = c + consume(body_fn(*args_))
            return c

        run()
        bench._sync(dev)
        best = min(bench._region_ms(run, dev) for _ in range(3)) / n
        busy[name] = bench._profiled(run, dev, n)[0]
        return best

    def total(ts):
        return sum(torch.sum(t.to(torch.float32)) for t in ts)

    res = {}
    res["pyramid_ms"] = probe("pyramid", lambda g: build_pyramid(g, cfg),
                              total)
    res["pyr_fast_ms"] = probe(
        "pyr_fast", lambda g: fast_score_levels(build_pyramid(g, cfg)), total)

    thr_low, thr_high = float(cfg.fast_threshold_low), float(
        cfg.fast_threshold)

    def cand_all(g):
        levels = build_pyramid(g, cfg)
        outs = []
        for img, s in zip(levels, fast_score_levels(levels)):
            h, w = img.shape
            s = nms3x3(s) * border_mask(h, w, cfg.border, img.dtype, dev)
            s = torch.where(s > thr_low, s, torch.zeros_like(s))
            s = _cell_threshold_fallback(s, cfg.cell_size, thr_high)
            outs.extend(_cell_candidates(s, cfg.cell_size, cfg.max_per_cell))
        return outs

    res["pyr_fast_cand_ms"] = probe("pyr_fast_cand", cand_all, total)
    res["pyr_blur_ms"] = probe("pyr_blur", lambda g: [
        _pad_to(gaussian_blur(img, cfg.blur_ksize, cfg.blur_sigma), H0, W0)
        for img in build_pyramid(g, cfg)], total)

    def mom_all(g):
        out = []
        for img in build_pyramid(g, cfg):
            mm = moment_maps(img)
            out.append(torch.nn.functional.pad(
                mm, (0, W0 - mm.shape[2], 0, H0 - mm.shape[1])))
        return out

    res["pyr_moments_ms"] = probe("pyr_moments", mom_all, total)

    # cut-point bisection of the select/descriptor tail
    for cut in CUTS:
        res[f"cut_{cut}_ms"] = probe(
            f"cut_{cut}", lambda g, d, cut=cut: detect_until(g, d, cfg, cut),
            total, with_depth=True)

    res["detect_ms"] = probe(
        "detect", lambda g, d: detect(g, d, cfg),
        lambda f: (torch.sum(f.keypoints.uv) + torch.sum(f.keypoints.angle)
                   + torch.sum(f.descriptors.unpacked.to(torch.float32))
                   + torch.sum(f.keypoints.depth)), with_depth=True)

    # derived splits
    res["fast_only_ms"] = res["pyr_fast_ms"] - res["pyramid_ms"]
    res["cand_only_ms"] = res["pyr_fast_cand_ms"] - res["pyr_fast_ms"]
    res["blur_only_ms"] = res["pyr_blur_ms"] - res["pyramid_ms"]
    res["moments_only_ms"] = res["pyr_moments_ms"] - res["pyramid_ms"]
    res["brief_only_ms"] = res["cut_brief_ms"] - res["cut_orient_ms"]
    res["atlas_only_ms"] = res["cut_atlas_ms"] - res["cut_select_ms"]

    # bytes-moved lower bound (read the frame once per consumer pass;
    # write each product once), float32
    shapes = pyramid_shapes(H0, W0, cfg)
    lvl_px = sum(h * w for h, w in shapes)
    atlas_px = cfg.n_levels * H0 * W0
    lb = {
        "pyramid_write_MB": lvl_px * 4 / 1e6,
        "score_write_MB": lvl_px * 4 / 1e6,
        "blur_atlas_write_MB": atlas_px * 4 / 1e6,
        "moment_atlas_write_MB": 2 * atlas_px * 4 / 1e6,
        "level_px_total": lvl_px,
        "padded_atlas_px": atlas_px,
        "pad_waste_ratio": atlas_px / lvl_px,
    }
    lb["frame_read_MB"] = H0 * W0 * 4 / 1e6
    lb["total_MB"] = (lb["frame_read_MB"] + lb["pyramid_write_MB"]
                      + lb["score_write_MB"] + lb["blur_atlas_write_MB"]
                      + lb["moment_atlas_write_MB"])
    lb["bound_ms_at_3.35TBps"] = lb["total_MB"] * 1e6 / HBM_BYTES_PER_S * 1e3
    res = {k: round(v, 3) for k, v in res.items()}
    print(json.dumps({"substage_ms": res, "bytes_lower_bound": lb,
                      "device_busy_ms_per_frame": busy,
                      "device": str(dev), "gpu": bench._card(dev),
                      "frames": int(n)}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
