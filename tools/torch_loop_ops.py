#!/usr/bin/env python3
"""Count the PyTorch ops the port's loop pipeline dispatches, per stage, on
the CPU.

    python tools/torch_loop_ops.py

Runs the `full` preset of `modular_slam_tpu_torch` on the out-and-back
scene of tests/test_engine_full.py:67 (320x240, a keyframe every frame, an
8-keyframe pool so that compaction runs too) and counts, with a
`TorchDispatchMode`, the ops each stage dispatches (view ops excluded):
the frame step, the BoW query, the verification of the top-k candidates,
PGO, global BA, fusion, maintenance and the keyframe step as a whole.  It
then counts one PGO call at 1, 2 and 20 Gauss-Newton steps (32 CG steps
each).  The counts follow the code, not the sizes, so the small scene
gives the per-call op counts of the full-size run; on the card each op is
one or more kernel launches.  Prints one JSON object.
"""

from __future__ import annotations

import collections
import json
import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from modular_slam_tpu_torch.backend import posegraph  # noqa: E402
from modular_slam_tpu_torch.config import (  # noqa: E402
    BackendConfig, CameraConfig, DetectorConfig, LoopConfig, MapConfig,
    PnpConfig, SlamConfig, TrackerConfig)
from modular_slam_tpu_torch.eval.synthetic import (  # noqa: E402
    PlaneSceneGenerator)
from modular_slam_tpu_torch.geometry.se3 import Pose  # noqa: E402
from modular_slam_tpu_torch.loop import pipeline  # noqa: E402
from modular_slam_tpu_torch.models import make_pipeline  # noqa: E402


class OpCount(TorchDispatchMode):
    """Counts dispatched ops that are not views."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def counted(fn, counts, key):
    def wrapper(*args, **kwargs):
        c = OpCount()
        with c:
            out = fn(*args, **kwargs)
        counts[key].append(c.n)
        return out
    return wrapper


def stage_counts() -> dict:
    cfg = SlamConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                            width=320, height=240),
        detector=DetectorConfig(n_levels=4, max_keypoints=384),
        map=MapConfig(max_keyframes=8, max_landmarks=4096,
                      max_observations=16384),
        pnp=PnpConfig(n_hypotheses=64),
        backend=BackendConfig(max_iterations=8),
        loop=LoopConfig(min_gap_keyframes=4, min_score=0.10, min_inliers=25,
                        max_covis_overlap=1_000_000),
        tracker=TrackerConfig(new_keyframe_min_inliers=400))
    gen = PlaneSceneGenerator(cfg.camera, seed=34)
    out = gen.trajectory(6, step_t=(0.25, 0.0, 0.0))
    system = make_pipeline("full", cfg, device="cpu")
    lp = system._loop
    counts = collections.defaultdict(list)
    for obj, name, key in ((system, "_step", "frame_step"),
                           (system, "_maybe_compact", "maintenance"),
                           (lp, "_query", "query"),
                           (lp, "_verify_slots", "verification"),
                           (lp, "_pgo", "pgo"),
                           (lp, "_exec_global_ba", "global_ba"),
                           (lp, "on_new_keyframe", "keyframe_step")):
        setattr(obj, name, counted(getattr(obj, name), counts, key))
    pipeline.fuse_duplicate_landmarks = counted(
        pipeline.fuse_duplicate_landmarks, counts, "fusion")
    for frame in gen.sequence(out + out[::-1][1:]):
        system.process(*frame)
    counts["closures"] = [system.n_loop_closures]
    counts["compactions"] = [system.n_compactions]
    return dict(counts)


def pgo_counts() -> dict:
    K, E = 16, 32
    q = torch.zeros(K, 4)
    q[:, 0] = 1.0
    t = torch.randn(K, 3, generator=torch.Generator().manual_seed(0))
    edges = posegraph.empty_edges(E)
    for e in range(10):
        posegraph.add_edge(edges, e, e, e + 1,
                           Pose(q=torch.tensor([1.0, 0.0, 0.0, 0.0]),
                                t=t[e + 1] - t[e]))
    out = {}
    for iters in (1, 2, 20):
        c = OpCount()
        with c:
            posegraph.optimize_pose_graph(q, t, torch.arange(K) < 11, edges,
                                          iters=iters, cg_iters=32)
        out[f"gn_steps_{iters}"] = c.n
    return out


def main() -> int:
    torch.set_num_threads(2)
    print(json.dumps({"stages": stage_counts(), "pgo": pgo_counts()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
