"""The harness: every cell, configuration, traffic, limit and metric file
found by name; a dummy cell added as files alone; the result line's
shape; the metric readers on a recorded trace; the no-JAX check by whole
top-level names."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from port_bench import peaks, run as R, trace
from port_bench.tests.conftest import Args, tiny_fleet, tiny_gba

ROOT = Path(R.__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = R.load_cell(cell)
    assert callable(R.driver_class(c["traffic"]["kind"]))
    assert set(c["limits"]) and all(isinstance(v, (int, float))
                                     for v in c["limits"].values())
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_reader_loads_by_name(metric):
    assert callable(R.metric_reader(metric))


def test_benchmark_json_keeps_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("port_bench/")
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and NAME.match(m["name"])
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])


def test_a_cell_added_as_files_alone_runs_through_the_harness(tmp_path):
    """A later change adds a cell, its traffic, its limits and a metric as
    new files and entries; no file of the harness changes."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fr1_desk.fleet8", "config": "tum_fr1_desk",
                               "traffic": "fleet8", "chips": 1, "why": "dummy"})
    bench["per_layer"].append({"name": "dummy.units", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "seq_frames_per_s",
                               "workloads": ["fr1_desk.fleet8"]})
    for m in bench["end_to_end"]:
        if m["name"] == "seq_frames_per_s":
            m["workloads"].append("fr1_desk.fleet8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "port_bench"
    traffic = json.loads((pb / "traffic" / "fleet.json").read_text())
    traffic["batch"] = 8
    (pb / "traffic" / "fleet8.json").write_text(json.dumps(traffic))
    shutil.copy(pb / "limits" / "fr1_desk.fleet.json",
                pb / "limits" / "fr1_desk.fleet8.json")
    (pb / "metrics" / "dummy.units.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    cell = R.load_cell("fr1_desk.fleet8", root=tmp_path)
    assert cell["traffic"]["batch"] == 8
    assert [m["name"] for m in cell["end_to_end"]] == ["seq_frames_per_s", "setup_s"]
    assert "dummy.units" in [m["name"] for m in cell["per_layer"]]
    reader = R.metric_reader("dummy.units", bench_dir=pb)
    assert reader({"units": 16}) == 16.0


def test_a_traffic_of_a_new_kind_runs_as_files_alone(tmp_path, cpu_run, monkeypatch):
    """A traffic whose kind no driver has yet brings its driver as a file
    of its own (`drivers/<kind>.py`), found by name: the harness runs the
    cell through set-up, window, traced window and judgement unedited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fr1_desk.echo", "config": "tum_fr1_desk",
                               "traffic": "echo", "chips": 1, "why": "dummy"})
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock", "workloads": ["fr1_desk.echo"]})
    bench["per_layer"].append({"name": "echo.units", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "echo_per_s",
                               "workloads": ["fr1_desk.echo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    pb = tmp_path / "port_bench"
    (pb / "traffic" / "echo.json").write_text(json.dumps({"kind": "echo"}))
    (pb / "limits" / "fr1_desk.echo.json").write_text(json.dumps({"echo_gap": 0}))
    (pb / "metrics" / "echo.units.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    (pb / "drivers" / "echo.py").write_text(
        "class Driver:\n"
        "    def __init__(self, cfg, traffic, seed, device='cuda'):\n"
        "        self.attempted, self.failed = 3, 0\n"
        "    def setup(self):\n        pass\n"
        "    def window(self, seconds):\n        return {'echo_per_s': 3 / seconds}\n"
        "    def traced_work(self):\n        return (lambda: None), 3\n"
        "    def shapes(self):\n        return {}\n"
        "    def collect(self):\n        pass\n"
        "    def numbers(self, dtype=None):\n        return {'echo_gap': 0.0}\n")
    cell = R.load_cell("fr1_desk.echo", root=tmp_path)
    res = cpu_run(cell, seed=7, seconds=1.5)
    assert res["correct"] and res["metrics"]["echo_per_s"]["value"] == 2.0
    assert res["checks"] == {"echo_gap": {"value": 0.0, "limit": 0.0}}
    # the CPU has no device trace: the recorded one stands in
    monkeypatch.setattr(trace, "record", lambda work: (work(), _recorded_trace())[1])
    res = R.run(Args(7, 1.5, trace=1), cell, device_check=False, device="cpu")
    assert res["metrics"] == {"echo.units": {"value": 3.0, "unit": "frames"}}
    assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]


def test_no_jax_check_compares_whole_top_level_names():
    mods = ["modular_slam_tpu_torch", "modular_slam_tpu_torch.engine",
            "jaxtyping", "numpy", "flaxen"]
    assert R.forbidden_modules(mods) == []
    assert R.forbidden_modules(mods + ["jax.numpy", "modular_slam_tpu.ops",
                                       "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "modular_slam_tpu.ops"]


def _recorded_trace():
    """A tiny trace as the profiler records it: two batched frames with
    K1, K2, the merge and some PyTorch kernels, idle gaps between."""
    dev = [("fast_score_levels_kernel(Levels)", 0, 20_000),
           ("hamming_2nn_kernel", 30_000, 40_000),
           ("hamming_merge_kernel", 40_000, 41_000),
           ("void at::native::indexFuncLargeIndex<float>", 50_000, 60_000),
           ("Memcpy HtoD (Pageable -> Device)", 60_000, 70_000),
           ("fast_score_levels_kernel(Levels)", 100_000, 120_000),
           ("hamming_2nn_kernel", 130_000, 140_000)]
    host = [("aten::copy_", 20_000, 29_000), ("cudaLaunchKernel", 70_000, 99_000)]
    return trace.reduce(dev, host, 200e-6)


def test_trace_reduction():
    tr = _recorded_trace()
    assert tr.busy_s == pytest.approx(81_000e-9)
    assert tr.device_ops[0] == ("fast_score_levels_kernel(Levels)",
                                pytest.approx(40e-6))
    labels = dict(tr.idle_gaps)
    assert labels["cudaLaunchKernel"] == pytest.approx(30e-6)
    assert labels["aten::copy_"] == pytest.approx(10e-6)


def test_metric_readers_on_a_recorded_trace():
    tr = _recorded_trace()
    shapes = {"batch": 4, "levels": peaks.pyramid_shapes(480, 640, 8, 1.2),
              "n_query": 512, "n_train": 16384}
    ctx = {"trace": tr, "units": 2, "shapes": shapes}

    def read(name):
        return R.metric_reader(name)(ctx)

    assert read("fleet.busy_ms_per_frame") == pytest.approx(81e-6 * 1e3 / 2)
    assert read("step.kernels_per_frame") == 6 / 2
    k1 = 2 * peaks.k1_bytes(shapes["levels"], 4) / peaks.HBM_BYTES_PER_S
    assert read("k1.fast_score_roofline") == pytest.approx(100 * k1 / 40e-6)
    k2 = 2 * peaks.k2_ops(4, 512, 16384) / peaks.INT8_OPS_PER_S
    assert read("k2.hamming_2nn_roofline") == pytest.approx(100 * k2 / 20e-6)
    assert read("device.idle_pct.fleet") == pytest.approx(100 * (1 - 81 / 200))
    assert read("device.idle_pct.gba") == read("device.idle_pct.fleet")
    assert read("gba.segment_sum_ms") == pytest.approx(10e-6 * 1e3 / 2)
    # a reader that finds nothing to read returns nothing
    empty = {"trace": trace.reduce([], [], 1e-3), "units": 2, "shapes": shapes}
    for name in ("k1.fast_score_roofline", "k2.hamming_2nn_roofline",
                 "gba.segment_sum_ms", "device.idle_pct.gba",
                 "fleet.busy_ms_per_frame", "step.kernels_per_frame"):
        assert R.metric_reader(name)(empty) is None, name
    # BENCHMARK.json's `workloads` alone decides where a metric is read
    fleet = {m["name"] for m in R.load_cell("fr1_desk.fleet")["per_layer"]}
    gba = {m["name"] for m in R.load_cell("fr1_room.gba")["per_layer"]}
    assert "gba.segment_sum_ms" in gba - fleet
    assert "k1.fast_score_roofline" in fleet - gba


def test_k1_bytes_of_the_default_pyramid():
    # PERF.md's K1 row: 7,604,256 B for one 640x480 frame
    assert peaks.k1_bytes(peaks.pyramid_shapes(480, 640, 8, 1.2), 1) == 7_604_256
    assert peaks.k2_ops(1, 512, 16384) == 4_294_967_296


def _shape_of(res):
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}


def test_fleet_result_line_shape(cpu_run):
    res = cpu_run(tiny_fleet())
    _shape_of(res)
    assert set(res["metrics"]) == {"seq_frames_per_s", "setup_s"}
    assert set(res["checks"]) == {"kp_miss_pct", "match_gap_pct", "kf_pose_gap_mm",
                                  "frames_not_tracked"}
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    json.dumps(res)


def test_gba_result_line_shape(cpu_run):
    res = cpu_run(tiny_gba())
    _shape_of(res)
    assert set(res["metrics"]) == {"gba_ms", "setup_s"}
    assert res["correct"]


@pytest.mark.card
def test_a_cell_on_the_card(card):
    """The fleet cell at the tiny size on the card, through the kernels."""
    import torch

    from port_bench.tests.conftest import Args

    res = R.run(Args(2 ** 31 + 5, 2.0), tiny_fleet(), device="cuda")
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert torch.cuda.max_memory_allocated() > 0
