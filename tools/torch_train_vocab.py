#!/usr/bin/env python3
"""Train and calibrate the port's BoW vocabulary on real descriptor
statistics (counterpart of tools/train_vocab.py, on the port's detector):

1. harvests BRIEF descriptors from rendered synthetic scenes (several
   textures and viewpoints) and from TUM-format frames on disk
   (`data/sample`, and any directory given with `--real-data`), with the
   port's `detect` on the device (K1 on the card);
2. trains a spherical-k-means codebook (`loop/vocab.py::train_vocab`) and
   writes it to `modular_slam_tpu_torch/data/vocab_<V>_<bits>.npz`, where
   `loop/vocab.py::load_trained_vocab` reads it (or to `--out`);
3. sweeps the BoW score threshold over same-place / different-place
   keyframe pairs from held-out rendered revisits (plane and box worlds)
   and reports precision and recall per threshold, the
   `LoopConfig.min_score` operating point; the random-projection codebook
   beside it.

    python tools/torch_train_vocab.py [--vocab-size 1024] [--out F]
        [--device cuda] [--scenes 6] [--frames-per-scene 6]
        [--revisit-scenes 4] [--real-data DIR ...] [--tiny]

The tables go to stderr, as the JAX tool's do; the last stdout line is one
JSON object with the output path, the descriptor count and the median
same- and different-place scores.  `--device` defaults to "cuda" and
raises without a CUDA device; `--tiny` runs `tiny_test_config()`, a
smoke run whose codebook is not one to ship.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LUMA = np.array([0.299, 0.587, 0.114], np.float32)
REAL_DATA = (os.path.join(REPO, "data", "sample"),)
REAL_FRAMES = 8          # frames read from each real-data directory


def _features(cfg, dev, rgb, depth):
    """The port's detect on one host frame (luma as the JAX tool makes
    it, a float32 product on the host)."""
    from modular_slam_tpu_torch.ops.detector import detect
    from modular_slam_tpu_torch.utils.device import upload

    gray = upload(np.ascontiguousarray(rgb.astype(np.float32) @ LUMA), dev)
    return detect(gray, upload(np.asarray(depth, np.float32), dev),
                  cfg.detector)


def harvest_descriptors(cfg, n_scenes: int = 6, frames_per_scene: int = 6,
                        *, device="cuda", roots=REAL_DATA):
    """-> [N, 256] ±1 int8 from rendered scenes + TUM frames in `roots`."""
    from modular_slam_tpu_torch.engine import _resolve_device
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator

    dev = _resolve_device(device)
    out = []

    def collect(rgb, depth):
        feats = _features(cfg, dev, rgb, depth)
        valid = feats.keypoints.valid.cpu().numpy()
        out.append(feats.descriptors.unpacked.cpu().numpy()[valid])

    for s in range(n_scenes):
        gen = PlaneSceneGenerator(cfg.camera, seed=1000 + s,
                                  texture_ppm=200.0 + 60.0 * s)
        poses = gen.trajectory(frames_per_scene,
                               step_t=(0.08, 0.03 * (s % 3 - 1), 0.01),
                               step_rot=(0.002, 0.004, 0.002))
        for rgb, depth, _ in gen.sequence(poses):
            collect(rgb, depth)

    for root in roots:
        if not os.path.isdir(root):
            continue
        from modular_slam_tpu_torch.io.tum import TumRgbdDataset

        try:
            ds = TumRgbdDataset(root)
        except (OSError, ValueError) as e:
            print(f"skipping {root}: {e}", file=sys.stderr)
            continue
        for i, (rgb, depth, _) in enumerate(ds):
            if i >= REAL_FRAMES:
                break
            collect(rgb, depth)
        print(f"harvested from {root}", file=sys.stderr)

    desc = np.concatenate(out)
    print(f"harvested {len(desc)} descriptors", file=sys.stderr)
    return desc


def revisit_pairs(cfg, vocab, n_scenes: int = 4, n_spots: int = 6,
                  scene: str = "plane", *, device="cuda"):
    """BoW scores for same-place and different-place keyframe pairs from
    held-out rendered scenes (plane or box world).  Same place = one spot
    revisited with small pose jitter (the loop-closure situation);
    different = other spots of the same scene."""
    import torch

    from modular_slam_tpu_torch.engine import _resolve_device
    from modular_slam_tpu_torch.eval.synthetic import (BoxSceneGenerator,
                                                       PlaneSceneGenerator)
    from modular_slam_tpu_torch.geometry.se3 import Pose
    from modular_slam_tpu_torch.loop.vocab import bow_histogram

    dev = _resolve_device(device)
    vocab_t = torch.as_tensor(np.asarray(vocab, np.int8), device=dev)
    same, diff = [], []
    for s in range(n_scenes):
        if scene == "box":
            gen = BoxSceneGenerator(cfg.camera, seed=2000 + s)
        else:
            gen = PlaneSceneGenerator(cfg.camera, seed=2000 + s,
                                      texture_ppm=250.0)
        hists = []
        for k in range(n_spots):
            # box wall spans x in [-5, 5]; boxes in [-2.2, 2.2]
            span = 0.8 if scene == "box" else 0.45
            spot = np.array([span * k - span * n_spots / 2,
                             0.15 * (k % 2), 0.0], np.float32)
            hs = []
            for jit_i in range(2):  # visit + revisit with pose jitter
                rng = np.random.default_rng(31 * k + jit_i + 7 * s)
                t = spot + rng.normal(0, 0.02, 3).astype(np.float32)
                rgb, depth = gen.render(
                    Pose(q=np.asarray([1.0, 0, 0, 0], np.float32), t=t))
                feats = _features(cfg, dev, rgb, depth)
                hs.append(bow_histogram(feats.descriptors.unpacked,
                                        feats.keypoints.valid,
                                        vocab_t).cpu().numpy())
            hists.append(hs)
        for k in range(n_spots):
            same.append(float(np.dot(hists[k][0], hists[k][1])))
            for k2 in range(k + 1, n_spots):
                diff.append(float(np.dot(hists[k][0], hists[k2][0])))
    return np.array(same), np.array(diff)


def sweep(same: np.ndarray, diff: np.ndarray):
    rows = []
    for thr in np.arange(0.05, 0.95, 0.05):
        tp = float((same >= thr).mean())
        fp = float((diff >= thr).mean())
        prec = tp / max(tp + fp, 1e-9)
        rows.append((round(float(thr), 2), round(tp, 3), round(fp, 3),
                     round(prec, 3)))
    return rows


def _report(title, same, diff):
    print(f"\n-- operating-point sweep ({title}) --", file=sys.stderr)
    print(f"same-place scores:  min {same.min():.3f} med "
          f"{np.median(same):.3f}", file=sys.stderr)
    print(f"diff-place scores:  med {np.median(diff):.3f} max "
          f"{diff.max():.3f}", file=sys.stderr)
    print("thr   recall  fp_rate  precision", file=sys.stderr)
    for thr, rec, fp, prec in sweep(same, diff):
        print(f"{thr:4.2f}  {rec:6.3f}  {fp:7.3f}  {prec:9.3f}",
              file=sys.stderr)
    return {"same_median": float(np.median(same)),
            "diff_median": float(np.median(diff)),
            "diff_max": float(diff.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vocab-size", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--scenes", type=int, default=6,
                    help="rendered scenes to harvest from")
    ap.add_argument("--frames-per-scene", type=int, default=6)
    ap.add_argument("--revisit-scenes", type=int, default=4,
                    help="held-out scenes of each revisit sweep")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny_test_config() (a smoke run)")
    ap.add_argument("--real-data", action="append", default=[],
                    help="another TUM-format directory to harvest from "
                         "(data/sample is always read when present)")
    args = ap.parse_args(argv)

    from modular_slam_tpu_torch.config import SlamConfig, tiny_test_config
    from modular_slam_tpu_torch.engine import _resolve_device
    from modular_slam_tpu_torch.loop.vocab import make_vocab, train_vocab

    dev = _resolve_device(args.device)
    cfg = tiny_test_config() if args.tiny else SlamConfig()
    desc = harvest_descriptors(cfg, args.scenes, args.frames_per_scene,
                               device=dev,
                               roots=REAL_DATA + tuple(args.real_data))
    vocab = train_vocab(desc, args.vocab_size, iters=args.iters)

    out = args.out or os.path.join(
        REPO, "modular_slam_tpu_torch", "data",
        f"vocab_{args.vocab_size}_{vocab.shape[1]}.npz")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, vocab=vocab)
    print(f"wrote {out}", file=sys.stderr)

    n = args.revisit_scenes
    same, diff = revisit_pairs(cfg, vocab, n, device=dev)
    plane = _report("trained vocab, plane", same, diff)
    same_b, diff_b = revisit_pairs(cfg, vocab, n, scene="box", device=dev)
    box = _report("trained vocab, BOX world", same_b, diff_b)

    print("\n-- random-projection vocab (round-1 baseline) --",
          file=sys.stderr)
    same_r, diff_r = revisit_pairs(cfg, make_vocab(args.vocab_size), n,
                                   device=dev)
    sep_r = float(np.median(same_r) - np.median(diff_r))
    sep = float(np.median(same) - np.median(diff))
    print(f"same med {np.median(same_r):.3f}  diff med "
          f"{np.median(diff_r):.3f}  separation {sep_r:.3f} "
          f"(trained: {sep:.3f})", file=sys.stderr)
    print(json.dumps({"out": out, "device": str(dev),
                      "descriptors": int(len(desc)),
                      "vocab_shape": list(vocab.shape), "plane": plane,
                      "box": box, "separation_trained": sep,
                      "separation_random": sep_r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
