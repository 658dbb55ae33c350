"""The benchmark of the PyTorch/CUDA port (`modular_slam_tpu_torch`).

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the card and
prints one JSON line last.  Everything a cell needs is found by name:
its configuration in `configs/`, its traffic mix in `traffic/` (whose
`kind` names the driver in `drivers/`), the limits of its output check in
`limits/`, and each per-layer metric's reader in `metrics/`.  The plain
references that decide `correct` live in `reference/`; they import
nothing of the port.
"""
