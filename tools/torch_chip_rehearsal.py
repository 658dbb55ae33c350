#!/usr/bin/env python3
"""Rehearse `chip_smoke.py`'s loop phases on the CPU, with no card.

    python tools/torch_chip_rehearsal.py [N_FRAMES]

Runs the `full`, `lifecycle` and `relocalize` phases of chip_smoke.py on
the first N_FRAMES (default 48) of its loop frames, on the CPU: device
"cuda" resolves to the CPU, `torch.cuda.synchronize` does nothing, and a
failed check is printed instead of raised (the launch-count check always
fails here: the CPU runs the kernels' plain versions, which launch
nothing).  Each phase prints its JSON line as on the card; its times are
the CPU's and say nothing about the card.  Use it to find wrong paths,
shapes and control flow before a chip call.
"""

from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from modular_slam_tpu_torch import engine  # noqa: E402
from modular_slam_tpu_torch.backend import ba, executor  # noqa: E402
from modular_slam_tpu_torch.loop import pipeline  # noqa: E402
from modular_slam_tpu_torch.ops import kernels  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    torch.set_num_threads(4)
    torch.cuda.synchronize = lambda *a, **k: None
    for module in (engine, ba, executor, pipeline):
        module._resolve_device = lambda device: torch.device("cpu")
    chip_smoke.check = lambda cond, msg: None if cond else print(
        "CHECK FAILED:", msg, flush=True)
    cfg = chip_smoke.loop_config()
    poses, frames = chip_smoke.loop_frames(cfg)
    poses, frames = poses[:n], frames[:n]
    t0 = time.perf_counter()
    chip_smoke.phase_full(torch, kernels, cfg, poses, frames)
    chip_smoke.phase_lifecycle(torch, cfg, poses, frames)
    chip_smoke.phase_relocalize(torch)
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
