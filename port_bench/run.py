"""Run one cell of the benchmark once on the card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
are read from `BENCHMARK.json` and the files it names; the traffic's
`kind` names the driver, the class `Driver` of `drivers/<kind>.py`,
which sets up, runs the measured window and judges the outputs.  With `--trace 0` the result
holds the cell's end-to-end metrics; with `--trace 1` its per-layer
metrics, each read by `metrics/<name>.py` from a short traced window run
after the measured one.  The last line of standard output is one JSON
object; the numbers that decide `correct` are printed beside their limits
as the last lines of standard error and under the result's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "modular_slam_tpu"})


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `modular_slam_tpu_torch` is not
    `modular_slam_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / ".port_bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor")}


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entries: workload, config (with its file's contents),
    traffic (its file), limits, the metrics it reports, and the folder
    its driver and metric readers are found in."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / "port_bench"

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "workload": w,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        "limits": json.loads((bench_dir / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "run_seconds": bench["run_seconds"],
        "bench_dir": bench_dir,
    }


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """`read(ctx)` of metrics/<name>.py."""
    return _load(bench_dir / "metrics" / f"{name}.py",
                 f"port_bench_metric_{name}").read


def driver_class(kind: str, bench_dir: Path = BENCH_DIR):
    """`Driver` of drivers/<kind>.py: a traffic of a new kind brings its
    driver as a file of its own."""
    return _load(bench_dir / "drivers" / f"{kind}.py",
                 f"port_bench_driver_{kind}").Driver


def make_driver(cell: dict, seed: int, device="cuda"):
    cls = driver_class(cell["traffic"]["kind"], cell.get("bench_dir", BENCH_DIR))
    return cls(cell["config"], cell["traffic"], seed, device=device)


def judge(numbers: dict, limits: dict):
    """(correct, checks): each compared number at most its limit, and
    finite; `info.*` numbers are printed, not compared."""
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in numbers.items() if not k.startswith("info.")}
    missing = sorted(set(limits) - set(checks))
    if missing:
        raise KeyError(f"limits without a number: {missing}")
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def per_layer_metrics(cell: dict, tr, units: int, shapes: dict) -> dict:
    """The cell's per-layer metrics (those whose `workloads` name it, or
    that name none), each as its reader finds it; a reader that finds
    nothing to read leaves its metric out."""
    ctx = {"trace": tr, "units": units, "shapes": shapes}
    out = {}
    for m in cell["per_layer"]:
        v = metric_reader(m["name"], cell.get("bench_dir", BENCH_DIR))(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def program_root() -> Path:
    """The checkout whose port is measured: the program must be imported
    from beside the benchmark, never from an installed copy."""
    import modular_slam_tpu_torch

    where = Path(modular_slam_tpu_torch.__file__).resolve().parents[1]
    if where != ROOT:
        raise SystemExit(f"port_bench: modular_slam_tpu_torch imported from "
                         f"{where}, not from this checkout ({ROOT})")
    return where


def run(args, cell: dict, device_check: bool = True, device="cuda") -> dict:
    """One run of a cell; returns the result object (printing is the
    caller's)."""
    import torch

    program_root()
    chips = int(cell["workload"]["chips"])
    if device_check and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        raise SystemExit(f"port_bench: the cell asks for {chips} CUDA device(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                         "available")
    t0 = time.perf_counter()
    drv = make_driver(cell, args.seed, device=device)
    drv.setup()
    setup_s = time.perf_counter() - t0
    e2e = drv.window(float(args.seconds))
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
                   "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": int(drv.attempted),
              "failed": int(drv.failed)}
    if args.trace:
        from port_bench import trace

        work, units = drv.traced_work()
        tr = trace.record(work)
        result["metrics"] = per_layer_metrics(cell, tr, units, drv.shapes())
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    else:
        result["metrics"] = {m["name"]: {"value": (setup_s if m["name"] == "setup_s"
                                                   else e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell["end_to_end"]}
    found = forbidden_modules()
    if found:
        raise SystemExit(f"port_bench: loaded after the window: {found}")
    drv.collect()
    numbers = drv.numbers()
    result["correct"], result["checks"] = judge(numbers, cell["limits"])
    result["device"] = device_info
    info = {k: v for k, v in numbers.items() if k.startswith("info.")}
    checks = result.pop("checks")
    result["info"] = info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in cache_env(ROOT).items():
        os.environ[k] = v
    cell = load_cell(args.workload)
    try:
        result = run(args, cell)
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
