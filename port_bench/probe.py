"""Readings for setting the benchmark's limits and sizes, on the card.

    python3 port_bench/probe.py control --workload W --seeds S [S ...] \
        [--seconds T] [--batch B]
        per seed: set-up, a window of T s, then the compared numbers of
        the port's outputs and of the control, the plain pipeline run in
        bfloat16 in the port's place; one JSON line per seed.
    python3 port_bench/probe.py work --workload W --seeds S [S ...]
        [--seconds T] [--set dotted.key=json ...]
        per seed: set-up and a window; the end-to-end figure and, for
        global BA, each call's LM iterations.
    python3 port_bench/probe.py sweep --workload W --seed S --batch B [B ...]
        [--seconds T]
        the fleet's sequence-frames/s and set-up at each batch.

Both run in one process, one cell at a time, and print JSON lines.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _driver(cell, seed, batch, sets=()):
    from port_bench import run as R

    if batch:
        cell["traffic"]["batch"] = batch
    for item in sets:
        path, value = item.split("=", 1)
        *parents, leaf = path.split(".")
        node = cell["traffic"]
        for p in parents:
            node = node[p]
        node[leaf] = json.loads(value)
    return R.make_driver(cell, seed)


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from port_bench import run as R

    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("control", "sweep", "work"))
    ap.add_argument("--set", action="append", default=[],
                    help="traffic override, dotted.key=json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for k, v in R.cache_env(ROOT).items():
        os.environ[k] = v
    import torch

    if args.mode == "work":
        for seed in args.seeds:
            cell = R.load_cell(args.workload)
            drv = _driver(cell, seed, args.batch[0] if args.batch else None, args.set)
            drv.setup()
            e2e = drv.window(args.seconds)
            ends = getattr(drv, "call_ends", None)
            print(json.dumps({"seed": seed, **e2e,
                              "iterations": getattr(drv, "iterations", None),
                              "call_ms": (None if ends is None else
                                          [round(1e3 * (b - a), 2) for a, b in
                                           zip([0.0] + ends[:-1], ends)])}),
                  flush=True)
            del drv
            torch.cuda.empty_cache()
    elif args.mode == "control":
        for seed in args.seeds:
            cell = R.load_cell(args.workload)
            drv = _driver(cell, seed, args.batch[0] if args.batch else None, args.set)
            t0 = time.perf_counter()
            drv.setup()
            setup_s = time.perf_counter() - t0
            e2e = drv.window(args.seconds)
            drv.collect()
            prog = drv.numbers()
            ctrl = drv.numbers(dtype=torch.bfloat16)
            print(json.dumps({"seed": seed, "setup_s": setup_s, **e2e,
                              "phases": getattr(drv, "setup_phases", None),
                              "failed": drv.failed, "attempted": drv.attempted,
                              "program": prog, "control": ctrl}), flush=True)
            del drv
            torch.cuda.empty_cache()
    else:
        for b in args.batch:
            cell = R.load_cell(args.workload)
            drv = _driver(cell, args.seed, b)
            t0 = time.perf_counter()
            drv.setup()
            setup_s = time.perf_counter() - t0
            e2e = drv.window(args.seconds)
            print(json.dumps({"batch": b, "setup_s": setup_s, **e2e,
                              "failed": drv.failed, "attempted": drv.attempted,
                              "peak_bytes": torch.cuda.max_memory_allocated()}),
                  flush=True)
            del drv
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
