#!/usr/bin/env python3
"""Count the host syncs of the port's per-frame and chunked odometry step
on the card, for this checkout or another one.

    python tools/torch_sync_count.py [--root DIR]

`--root` imports `modular_slam_tpu_torch` from DIR (for example an
unpacked earlier commit), so two versions of the step are counted by the
same code.  With `SlamConfig()` (640x480) on 16 rendered frames of
`chip_smoke.py`'s fast-motion sequence it traces, with `chip_smoke.py`'s
`_traced` (the sync debug mode's warnings, by innermost repository line),
one `SlamSystem.process` call on a tracked frame and one on a keyframe
frame, and — where the checkout has it — the second of two 16-frame
`process_chunk` calls.  Prints one JSON object.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.root), HERE]

    import torch

    import chip_smoke
    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.engine import SlamSystem
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator

    if not torch.cuda.is_available():
        print("torch_sync_count: no CUDA device", file=sys.stderr)
        return 2
    cfg = SlamConfig()
    gen = PlaneSceneGenerator(cfg.camera, seed=0)
    m = chip_smoke.FAST_MOTION
    poses = gen.trajectory(
        32, step_t=tuple(m * x for x in chip_smoke.STEP_T),
        step_rot=tuple(m * x for x in chip_smoke.STEP_ROT))
    frames = list(gen.sequence(poses))

    def traced(fn):
        _, row = chip_smoke._traced(torch, fn)
        return {k: row[k] for k in ("host_syncs", "host_sync_sites",
                                    "device_ops", "wall_ms")}

    system = SlamSystem(cfg, device="cuda", seed=0, enable_backend=False)
    system.process(*frames[0])
    rows = {}
    for k, f in enumerate(frames[1:16], 1):
        row = traced(lambda f=f: system.process(*f))
        kind = ("process_keyframe_frame"
                if bool(system.results[-1].new_keyframe)
                else "process_tracked_frame")
        rows.setdefault(kind, {"frame": k, **row})
        if len(rows) == 2:
            break
    if hasattr(SlamSystem, "process_chunk"):
        chunked = SlamSystem(cfg, device="cuda", seed=0,
                             enable_backend=False)
        chunked.process_chunk(*zip(*frames[:16]))
        rows["process_chunk_16"] = traced(
            lambda: chunked.process_chunk(*zip(*frames[16:32])))
        rows["process_chunk_16"]["keyframes"] = sum(
            bool(r.new_keyframe) for r in chunked.results[16:])
    smi = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "card": smi.stdout.strip(), **rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
