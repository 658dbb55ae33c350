"""The program's spans in a trace of the card: what each layer of the port
launched, how long its host work took, and where the card idled.

The port marks its layers' boundaries with
`modular_slam_tpu_torch.utils.profiling.span`: host ranges on the torch
profiler's timeline, recorded only while a profiler records host
activity.  They are record functions of the function scope, not user
annotations, so the profiler projects no copy of them onto the card's
stream, and they are told from ATen's ops by the prefix of their names
(the port's `SPAN_PREFIX`), which `split` takes off.  A kernel
belongs to every span open when its launch began on the host: its CUDA
event and the runtime call that launched it share a correlation id.

`record(run)` traces one window of `run()` with both the card's and the
host's activity (the window that holds the spans), and `table` reduces it
to, per span name, its count, its host seconds, the device seconds of
the kernels launched inside it, and the idle seconds of the device gaps
that open while it is the innermost span open (a gap's start is put on
the host's clock by the launch that ends it).  `FIGURES` are the
per-layer figures read from that table, per unit of the traced window
(a batched frame of a fleet, a call of global BA); each is None where
its span is absent, as in a program without spans, so a trace gives the
figures of the spans it holds.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

Event = Tuple[str, int, int]            # (name, start ns, end ns)


class SpanTrace(NamedTuple):
    kernels: List[Event]    # device events, user annotations left out
    launches: List[int]     # host ns at which each kernel's launch began; -1 unknown
    spans: List[Event]      # the program's spans
    host: List[Event]       # every other host event (ops, runtime calls)
    window_s: float         # the traced window, host clock


def span_prefix() -> Optional[str]:
    """The prefix of the port's span names; None for a program without
    spans."""
    try:
        from modular_slam_tpu_torch.utils.profiling import SPAN_PREFIX
    except ImportError:
        return None
    return SPAN_PREFIX


def split(events: Iterable, window_s: float) -> SpanTrace:
    """A SpanTrace of kineto events (`prof.profiler.kineto_results.events()`
    or objects with the same methods).  User annotations, on the host and
    their projection onto the card (`gpu_user_annotation`), go to no list.
    A host event whose name begins with `span_prefix()` is a span, named
    without it.  A kernel's launch is the start of the CUDA runtime or
    driver call (`cuda*`, `cu*`) that carries its correlation id."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    prefix = span_prefix()
    dev, corr, spans, host, calls = [], [], [], [], {}
    for e in events:
        s = e.start_ns()
        item = (e.name(), s, s + e.duration_ns())
        if e.is_user_annotation():
            continue
        if e.device_type() == cuda:
            dev.append(item)
            corr.append(e.correlation_id())
        elif prefix and item[0].startswith(prefix):
            spans.append((item[0][len(prefix):], s, item[2]))
        else:
            host.append(item)
            if item[0].startswith("cu"):
                calls[e.correlation_id()] = s
    return SpanTrace(kernels=dev, launches=[calls.get(c, -1) for c in corr],
                     spans=spans, host=host, window_s=window_s)


def record(run: Callable[[], None]) -> SpanTrace:
    """Trace one window of run() with the host's activity and, where there
    is a card, the card's, synchronised at both ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        window_s = time.perf_counter() - t0
    return split(prof.profiler.kineto_results.events(), window_s)


class _Open:
    """The spans of each name, by start, for 'which span of this name holds
    host time t' (same-name spans do not overlap)."""

    def __init__(self, spans: List[Event]):
        by: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for name, s, e in spans:
            by[name].append((s, e))
        self.by = {n: sorted(v) for n, v in by.items()}
        self.starts = {n: [s for s, _ in v] for n, v in self.by.items()}

    def holding(self, name: str, t: int) -> Optional[Tuple[int, int]]:
        j = bisect.bisect_right(self.starts[name], t) - 1
        if j >= 0 and self.by[name][j][1] >= t:
            return self.by[name][j]
        return None

    def innermost(self, t: int) -> Optional[str]:
        """The open span that began last before t (spans nest)."""
        best, best_s = None, None
        for name in self.by:
            iv = self.holding(name, t)
            if iv is not None and (best_s is None or iv[0] > best_s):
                best, best_s = name, iv[0]
        return best


def _gaps(tr: SpanTrace) -> Tuple[np.ndarray, np.ndarray]:
    """(start ns on the host's clock, length ns) of the idle gaps between
    the merged device intervals, as `trace.reduce` finds them.  A gap ends
    when the host launches the next device event onto the idle card, so
    its start on the host's clock is that launch's start less the gap's
    length (early by the launch latency, a few us); this holds however
    the session's clocks are skewed.  Where that launch is not found, the
    card's timestamp is taken."""
    if not tr.kernels:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    iv = np.asarray([(s, e) for _, s, e in tr.kernels], np.int64)
    order = np.argsort(iv[:, 0], kind="stable")
    iv = iv[order]
    ends = np.maximum.accumulate(iv[:, 1])
    brk = np.nonzero(iv[1:, 0] > ends[:-1])[0]
    length = iv[brk + 1, 0] - ends[brk]
    launch = np.asarray(tr.launches, np.int64)[order][brk + 1]
    start = np.where(launch >= 0, launch - length, ends[brk])
    return start, length


def table(tr: SpanTrace) -> Dict[str, Dict[str, float]]:
    """Per span name: `count`, `host_s` (the spans' own durations),
    `device_s` (the kernels launched inside a span of that name, at any
    depth) and `idle_s` (the device gaps that open while it is the
    innermost span open)."""
    if not tr.spans:
        return {}
    spans = _Open(tr.spans)
    out = {n: {"count": len(v), "host_s": sum(e - s for s, e in v) / 1e9,
               "device_s": 0.0, "idle_s": 0.0}
           for n, v in spans.by.items()}
    for (_, s, e), t in zip(tr.kernels, tr.launches):
        if t < 0:
            continue
        for name in spans.by:
            if spans.holding(name, t) is not None:
                out[name]["device_s"] += (e - s) / 1e9
    for g, n in zip(*_gaps(tr)):
        name = spans.innermost(int(g))
        if name is not None:
            out[name]["idle_s"] += float(n) / 1e9
    return out


def idle_labels(tr: SpanTrace, top: int = 10) -> List[Tuple[str, float]]:
    """The idle gaps' seconds by label, the top `top`: the innermost host
    event running when the gap opened, as `trace.reduce` labels it,
    prefixed by the innermost program span open then
    (`multiseq.collect/no host activity`); with no span open, the label
    alone."""
    spans = _Open(tr.spans)
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    out: Dict[str, float] = defaultdict(float)
    for g, n in zip(*_gaps(tr)):
        g = int(g)
        j = bisect.bisect_right(starts, g) - 1
        label, best = "no host activity", None
        for k in range(j, max(j - 64, -1), -1):
            name, s, e = host[k]
            if s <= g <= e and (best is None or e - s < best):
                label, best = name, e - s
        inner = spans.innermost(g)
        out[label if inner is None else f"{inner}/{label}"] += float(n) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def idle_s(tr: SpanTrace) -> float:
    """All idle seconds between the device intervals."""
    return float(_gaps(tr)[1].sum()) / 1e9


def _offset_ns(pairs) -> int:
    lead = [t - s for (_, s, _), t in pairs if t >= 0]
    return max(0, max(lead)) if lead else 0


def clock(tr: SpanTrace) -> dict:
    """How the card's timestamps sit against the host's: the kernels that
    start before the host began their launch (0 where one clock serves
    both), of all whose launch was found, and the most by which one does,
    in the window and in each quarter of its kernels (a skew that grows
    through the window shows as growing quarters).  The profiler brings
    the two clocks to one time base per session; host figures and the
    attribution of kernels by launch use the host's clock alone."""
    pairs = sorted(zip(tr.kernels, tr.launches), key=lambda p: p[0][1])
    found = [(k, t) for k, t in pairs if t >= 0]
    n = len(pairs)
    return {"kernels_before_launch": sum(s < t for (_, s, _), t in found),
            "launched": len(found),
            "offset_us": _offset_ns(pairs) / 1e3,
            "offset_us_by_quarter": [
                _offset_ns(pairs[i * n // 4:(i + 1) * n // 4]) / 1e3
                for i in range(4)]}


# name -> (span, quantity, scale): the figure is
# scale * table[span][quantity] / units
FIGURES = {
    "fleet.upload_host_ms": ("multiseq.upload", "host_s", 1e3),
    "fleet.draws_host_ms": ("prng.uniforms", "host_s", 1e3),
    "fleet.collect_host_ms": ("multiseq.collect", "host_s", 1e3),
    "step.dispatch_host_ms": ("step", "host_s", 1e3),
    "step.detect_ms": ("step.detect", "device_s", 1e3),
    "step.match_ms": ("track.match", "device_s", 1e3),
    "step.pnp_ms": ("track.pnp", "device_s", 1e3),
    "step.keyframe_ms": ("track.keyframe", "device_s", 1e3),
    "gba.stop_read_idle_ms": ("ba.stop_read", "idle_s", 1e3),
    "gba.stop_reads_per_call": ("ba.stop_read", "count", 1.0),
    "gba.segment_sum_span_ms": ("ba.segment_sum", "device_s", 1e3),
}


def figure(name: str, tab: Dict[str, Dict[str, float]], units: int):
    """One of FIGURES from a `table`, per unit; None where its span is
    absent."""
    span, quantity, scale = FIGURES[name]
    if span not in tab:
        return None
    return scale * tab[span][quantity] / units


def figures(tab: Dict[str, Dict[str, float]], units: int) -> dict:
    """Every one of FIGURES whose span the table holds, per unit."""
    out = {name: figure(name, tab, units) for name in FIGURES}
    return {k: v for k, v in out.items() if v is not None}
