"""Observability: per-stage wall-clock timing, the program's spans and
device traces (counterpart of modular_slam_tpu/utils/profiling.py).

`FrameTimer` is a copy of the JAX package's.  `span` marks a layer's
boundary (the multiseq chunk and its upload, draws and collect; the
tracked step's stages; a compact global BA call; the BA core's stop
reads and segment sums, in every solver that runs them) as a range on
the torch profiler's host timeline, beside the CUDA events its ops
launch; with no profiler recording it costs one flag test.
`device_trace` records a `torch.profiler` trace (the host ops and the
spans and, on the card, the CUDA kernels) and exports it as a Chrome
trace, viewable in Perfetto or chrome://tracing, where the JAX package
records a `jax.profiler` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List

import torch

_profiling = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()

# Every span's range is named `SPAN_PREFIX + name`, which no ATen op is.
SPAN_PREFIX = "mslam/"


def span(name: str):
    """A context manager that marks `name` on the profiler's host timeline
    while a torch profiler records, and does nothing otherwise (one flag
    test; the shared no-op context is returned).

    The range is a record function of the function scope, as ATen's own
    ops are: it nests with them on the host thread, and a kernel belongs
    to it when the runtime call that launched the kernel (the host event
    with the kernel's correlation id) began inside it.  It is not a user
    annotation, so the profiler projects no copy of it onto the card's
    stream, and a reader of the device's events sees kernels alone; a
    reader tells spans from ops by their name's `SPAN_PREFIX`.  Under
    `torch.func.vmap` it opens once per call of the vmapped function, not
    once per row."""
    if not _profiling():
        return _OFF
    return _range(SPAN_PREFIX + name)


class FrameTimer:
    """Wall-clock per-stage timing with summary statistics.

    The host clock with no synchronisation: on the card a stage times the
    enqueue of its kernels, not their device time (for that, record a
    `device_trace`, whose kernels carry the spans they were launched
    in)."""

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
    ops by name.

    The trace holds the program's spans (`span`) as host ranges around
    the ops and kernel launches of their layer: this is the way to see
    them, in Perfetto or chrome://tracing, for a run of one's own."""
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
