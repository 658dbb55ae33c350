"""Reading a torch.profiler trace of the card into what the per-layer
metrics and the result's breakdown need.

Device events are the CUDA activities of the trace (kernels, copies,
sets); the card is busy where any of them runs (the union of their
intervals) and idle elsewhere in the traced window.  An idle gap is
labelled by the innermost host operation running when it began.  A trace
is a lower bound of the device's work: the tracer drops an event now and
then (a long trace has shown 61 of 64 kernels of one kind).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class Trace(NamedTuple):
    kernels: List[Tuple[str, int, int]]    # device events (name, start ns, end ns)
    window_s: float                        # the traced window, host clock
    busy_s: float                          # union of device intervals
    device_ops: List[Tuple[str, float]]    # top 10 by total seconds
    idle_gaps: List[Tuple[str, float]]     # top 10 host activities by gap seconds


def idle_pct(tr: Trace):
    """The card's idle share of a traced window, in %; None where the
    trace holds no device activity."""
    if tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _union_s(iv: np.ndarray) -> Tuple[float, np.ndarray]:
    """(seconds covered, merged intervals [M, 2] ns) of intervals [N, 2]."""
    if iv.shape[0] == 0:
        return 0.0, iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    m = np.asarray(merged, np.int64)
    return float(np.sum(m[:, 1] - m[:, 0])) / 1e9, m


def _profiled(run: Callable[[], None], host: bool):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        item = (e.name(), s, s + e.duration_ns())
        (dev if e.device_type() == cuda else cpu).append(item)
    return dev, cpu, window_s


def record(run: Callable[[], None]) -> Trace:
    """Trace two windows of run() (each ends with the card synchronised):
    the first with the card's activity alone, which slows the host least,
    for every figure; the second with the host's operations too, only to
    label the idle gaps by what the host was doing."""
    dev, _, window_s = _profiled(run, host=False)
    dev2, cpu2, window2 = _profiled(run, host=True)
    labelled = reduce(dev2, cpu2, window2)
    return reduce(dev, [], window_s)._replace(idle_gaps=labelled.idle_gaps)


def reduce(dev: List[Tuple[str, int, int]], host: List[Tuple[str, int, int]],
           window_s: float) -> Trace:
    """The busy time, top device operations and labelled idle gaps of
    device and host events (name, start ns, end ns)."""
    iv = np.asarray([(s, e) for _, s, e in dev], np.int64).reshape(-1, 2)
    busy_s, merged = _union_s(iv)
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    gaps: Dict[str, float] = defaultdict(float)
    if merged.shape[0] > 1:
        host = sorted(host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        g_start, g_len = merged[:-1, 1], merged[1:, 0] - merged[:-1, 1]
        for i in np.argsort(-g_len)[:4000]:
            g = int(g_start[i])
            j = bisect.bisect_right(starts, g) - 1
            label, best = "no host activity", None
            for k in range(j, max(j - 64, -1), -1):
                name, s, e = host[k]
                if s <= g <= e and (best is None or e - s < best):
                    label, best = name, e - s
            gaps[label] += float(g_len[i]) / 1e9
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Trace(kernels=dev, window_s=window_s, busy_s=busy_s,
                 device_ops=device_ops, idle_gaps=idle_gaps)
