"""Observability: per-stage wall-clock timing and device traces
(counterpart of modular_slam_tpu/utils/profiling.py).

`FrameTimer` is a copy of the JAX package's.  `device_trace` records a
`torch.profiler` trace (the host ops and, on the card, the CUDA kernels)
and exports it as a Chrome trace, viewable in Perfetto or
chrome://tracing, where the JAX package records a `jax.profiler` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List


class FrameTimer:
    """Wall-clock per-stage timing with summary statistics."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self._samples.items():
            if not xs:
                continue
            xs_sorted = sorted(xs)
            n = len(xs)
            out[name] = {
                "n": n,
                "mean_ms": 1e3 * sum(xs) / n,
                "p50_ms": 1e3 * xs_sorted[n // 2],
                "p95_ms": 1e3 * xs_sorted[min(n - 1, int(n * 0.95))],
                "total_s": sum(xs),
            }
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str, name: str = "trace.json"):
    """Profile the block with `torch.profiler` (CPU activity, and CUDA
    activity when a card is present) and write the Chrome trace to
    `log_dir/name`.  Yields the profiler, whose `key_averages()` sums the
    ops by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))
