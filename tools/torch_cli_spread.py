#!/usr/bin/env python3
"""Run-to-run spread of the port's command-line runner on the dataset of
`chip_smoke.py`'s `cli` phase, on one CUDA card.

    python tools/torch_cli_spread.py [RUNS] [--out DIR] [--arg=--chunk=1 ...]

Writes the 640x480 two-lap loop (48 frames a lap, 1.2 m, 3 cm depth
noise, seed 3) with `eval/make_dataset.write_dataset` into a temporary
directory, then runs `python -m modular_slam_tpu_torch.run --pipeline full
--ate` with the phase's overrides RUNS times (default 3), each in its own
process as a user would, and prints one JSON line per run: the runner's
report, the command's seconds, and `ate_if_exact_from`: the frame ATE
RMSE the run would have had if every frame from the K-th on (K = 16,
32, 48: a chunk boundary) had been tracked exactly, its first K frames
as they were — what the backend could at best still win once those
frames were streamed — and `max_err_before`: the largest distance of
those K streamed positions from the ground truth, unaligned (both
trajectories start at the identity).  `--out DIR` keeps each run's
trajectory there, with the dataset's `groundtruth.txt`; `--dataset DIR`
keeps the dataset in DIR and reuses it when it is there.  Each `--arg=A`
appends A to the runner's command (repeatable; a later `--pipeline` or
`--chunk` overrides the phase's).  `--replay` runs `chip_smoke.py`'s
`cli_replay` phase RUNS times in this process instead (the JAX engine's
recorded draws), printing its line, or the failed check, per run.  Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from modular_slam_tpu_torch.eval.ate import ate_rmse  # noqa: E402
from modular_slam_tpu_torch.io import read_tum_trajectory  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", type=int, nargs="?", default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--arg", action="append", default=[])
    ap.add_argument("--dataset", default=None,
                    help="keep the dataset in DIR (written if absent)")
    ap.add_argument("--replay", action="store_true",
                    help="run the cli_replay phase instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="cli_spread_")
    try:
        ds = args.dataset or os.path.join(work, "loop")
        if not os.path.exists(os.path.join(ds, "groundtruth.txt")):
            chip_smoke.write_cli_dataset(ds)
        if args.replay:
            for k in range(args.runs):
                try:
                    chip_smoke.phase_cli_replay(torch, ds)
                except AssertionError as e:
                    print(json.dumps({"run": k, "failed": str(e)}),
                          flush=True)
            return 0
        out = args.out or work
        os.makedirs(out, exist_ok=True)
        shutil.copy(os.path.join(ds, "groundtruth.txt"), out)
        gt = read_tum_trajectory(os.path.join(ds, "groundtruth.txt"))
        for k in range(args.runs):
            t0 = time.perf_counter()
            p = subprocess.run(
                chip_smoke.cli_full_command(
                    ds, os.path.join(out, f"traj{k}.txt"), *args.arg),
                cwd=ROOT, capture_output=True, text=True, check=True)
            command_s = time.perf_counter() - t0
            rep = json.loads(p.stdout.strip().splitlines()[-1])
            est = read_tum_trajectory(os.path.join(out, f"traj{k}.txt"))
            floor, drift = {}, {}
            for first in (16, 32, 48):
                mixed = gt.copy()
                mixed[:first] = est[:first]
                floor[first] = ate_rmse(mixed, gt)["rmse"]
                drift[first] = float(np.linalg.norm(
                    est[:first, 1:4] - gt[:first, 1:4], axis=1).max())
            print(json.dumps({"run": k, "args": args.arg, **rep,
                              "ate_if_exact_from": floor,
                              "max_err_before": drift,
                              "command_s": command_s}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
