"""The program's spans in one cell's traced work, beside the benchmark's
own reading of that work.

    python3 port_bench/span_report.py --workload <cell> --seed <n> \
        [--seconds 10] [--repeats 2] [--out spans.json]

from the root of a checkout.  Sets the cell's driver up as `run.py` does
and runs its window for `--seconds` (the state the traced windows start
from), then, per repeat: `trace.record` of the driver's traced work (the
benchmark's two windows, from which every per-layer metric of
`BENCHMARK.json` is read) and `spans.record` of it again (one window
with the host's and the card's activity, from which the spans' figures
are read).  Prints one JSON object, and writes it to `--out` if given:

- `metrics`: the cell's per-layer metrics as `run.py --trace 1` reads them;
- `spans`: `spans.table` per span name, `figures`: the `spans.FIGURES`
  whose spans the window holds, per batched frame or call;
- `idle_labels`: the idle gaps by innermost span and host op;
- `idle_in_spans_pct`: the share of the idle time that opens inside a span;
- `clock`: `spans.clock`, kernels that start before the host began their
  launch and by how much;
- `window_s_per_unit`: the device-only window's and the span window's wall
  time per batched frame or call (the second's excess is the cost of
  recording the host);
- the checks of the figures against each other: `stage_device_over_busy`
  (the four stage figures' sum over `fleet.busy_ms_per_frame`),
  `host_over_wall` (the fleet's four host figures' sum over the span
  window's wall time per batched frame), `stop_reads` and `lm_iterations`
  (global BA's reads per call and the traced calls' LM iterations).

A program without spans gives the metrics and windows alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STAGES = ("step.detect_ms", "step.match_ms", "step.pnp_ms", "step.keyframe_ms")
HOST = ("fleet.upload_host_ms", "fleet.draws_host_ms",
        "fleet.collect_host_ms", "step.dispatch_host_ms")


def report(cell: dict, drv, repeats: int) -> dict:
    """The readings of `repeats` traced windows of a driver that is set up."""
    from port_bench import run as R
    from port_bench import spans, trace

    name = cell["workload"]["name"]
    prefix = spans.span_prefix()
    out = []
    for _ in range(repeats):
        work, units = drv.traced_work()
        tr = trace.record(work)
        metrics = R.per_layer_metrics(cell, tr, units, drv.shapes())
        gba, seen = getattr(drv, "gba", None), []
        if gba is not None:                 # a global-BA driver: count LM
            def counted(arena, gba=gba):    # iterations of the span window
                arena, stats = gba(arena)
                seen.append(int(stats.n_iterations))
                return arena, stats
            drv.gba = counted
        try:
            st = spans.record(work)
        finally:
            if gba is not None:
                drv.gba = gba
        tab = spans.table(st)
        fig = spans.figures(tab, units)
        idle = spans.idle_s(st)
        inside = sum(v["idle_s"] for v in tab.values())
        r = {"units": units, "metrics": metrics, "spans": tab, "figures": fig,
             "idle_labels": spans.idle_labels(st),
             "idle_in_spans_pct": 100.0 * inside / idle if idle else None,
             "clock": spans.clock(st),
             "device_ops": tr.device_ops,
             "span_in_device_ops": sorted(
                 n for n, _ in tr.device_ops if prefix and n.startswith(prefix)),
             "window_s_per_unit": {"device_only": tr.window_s / units,
                                   "spans": st.window_s / units}}
        busy = metrics.get("fleet.busy_ms_per_frame", {}).get("value")
        if busy and all(k in fig for k in STAGES):
            r["stage_device_over_busy"] = sum(fig[k] for k in STAGES) / busy
        if all(k in fig for k in HOST):
            r["host_over_wall"] = (sum(fig[k] for k in HOST)
                                   / (1e3 * st.window_s / units))
        if gba is not None:
            r["lm_iterations"] = seen
            r["stop_reads"] = tab.get("ba.stop_read", {}).get("count")
        out.append(r)
    return {"workload": name, "repeats": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from port_bench import run as R

    for k, v in R.cache_env(ROOT).items():
        os.environ[k] = v
    R.program_root()
    cell = R.load_cell(args.workload)
    t0 = time.perf_counter()
    drv = R.make_driver(cell, args.seed)
    drv.setup()
    setup_s = time.perf_counter() - t0
    drv.window(args.seconds)
    res = report(cell, drv, args.repeats)
    res.update(seed=args.seed, setup_s=setup_s)
    text = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
