"""The spans' reading (`port_bench/spans.py`): user annotations kept out of
the device events, kernels attributed to spans by their launch, idle gaps
labelled by the innermost span, the eleven figures on a hand-made trace
and None without spans, and the spans of the tiny cells on the CPU."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import run as R
from port_bench import spans, trace
from port_bench.tests.conftest import tiny_fleet, tiny_gba
from modular_slam_tpu_torch.utils.profiling import SPAN_PREFIX

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
STAGES = ("step.detect", "track.match", "track.pnp", "track.keyframe")
FLEET = {"fleet.upload_host_ms", "fleet.draws_host_ms",
         "fleet.collect_host_ms", "step.dispatch_host_ms", "step.detect_ms",
         "step.match_ms", "step.pnp_ms", "step.keyframe_ms"}
GBA = {"gba.stop_read_idle_ms", "gba.stop_reads_per_call",
       "gba.segment_sum_span_ms"}


class Ev:
    """A kineto event's methods, as `spans.split` reads them."""

    def __init__(self, name, s, e, dev=CPU, corr=0, ua=False):
        self._v = (name, s, e, dev, corr, ua)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def Span(name, s, e):
    """A span of the port, as the profiler names its range."""
    return Ev(SPAN_PREFIX + name, s, e)


def _launch(name, t, k0, k1, corr, api="cudaLaunchKernel"):
    """A launch at host time t and its device event, [k0, k1]."""
    return [Ev(api, t, t + 5, corr=corr), Ev(name, k0, k1, CUDA, corr)]


def _fleet_events():
    """Two batched frames of a chunk, by hand (ns), with the card idle
    between launches, so that each device event starts at its launch:
    chunk [0, 1000]: upload [10, 60] (a copy [20, 40]), draws [60, 80],
    step [100, 500] and [500, 900], each with detect, match, pnp and
    keyframe spans [s, s + 90] that launch one kernel of 10, 20, 30, 40
    ns at s + 5; collect [920, 990].  The gaps: 75 ns from the copy's end
    in the upload, then 90, 80, 70, 60 in detect, match, pnp, keyframe of
    frame 1 and 90, 80, 70 in those of frame 2."""
    ev = [Span("multiseq.chunk", 0, 1000), Span("multiseq.upload", 10, 60),
          Ev("aten::copy_", 12, 58), Span("prng.uniforms", 60, 80),
          Span("multiseq.collect", 920, 990)]
    ev += _launch("Memcpy HtoD (Pinned -> Device)", 20, 20, 40, 1,
                  "cudaMemcpyAsync")
    corr = 2
    for base in (100, 500):
        ev.append(Span("step", base, base + 400))
        for i, name in enumerate(STAGES):
            s = base + 10 + 100 * i
            ev.append(Span(name, s, s + 90))
            ev += _launch(f"kernel_{name}", s + 5, s + 5, s + 15 + 10 * i,
                          corr)
            corr += 1
    # a user annotation on the host and its projection onto the card
    ev += [Ev("my_annotation", 100, 200, ua=True),
           Ev("my_annotation", 130, 190, CUDA, corr=99, ua=True)]
    return ev


def test_user_annotations_never_reach_the_device_events():
    st = spans.split(_fleet_events(), 1e-6)
    names = {n for n, _, _ in st.kernels}
    assert "my_annotation" not in names and len(st.kernels) == 9
    assert "my_annotation" not in {n for n, _, _ in st.spans + st.host}
    assert {n for n, _, _ in st.spans} == set(STAGES) | {
        "step", "multiseq.chunk", "multiseq.upload", "prng.uniforms",
        "multiseq.collect"}
    assert not any(n.startswith(SPAN_PREFIX) for n, _, _ in st.host)
    tr = trace.reduce(st.kernels, st.host, st.window_s)
    assert not any(n.startswith(SPAN_PREFIX) or n == "my_annotation"
                   for n, _ in tr.device_ops)
    # the same busy time as the kernels alone give
    kernels_only = [e for e in _fleet_events()
                    if e.device_type() == CUDA and not e.is_user_annotation()]
    alone = trace.reduce([(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                          for e in kernels_only], [], 1e-6)
    assert tr.busy_s == alone.busy_s


def test_without_spans_the_labels_are_the_benchmarks():
    ev = [e for e in _fleet_events() if not e.name().startswith(SPAN_PREFIX)]
    st = spans.split(ev, 1e-6)
    assert st.spans == [] and spans.table(st) == {}
    ours = spans.idle_labels(st)
    theirs = trace.reduce(st.kernels, st.host, st.window_s).idle_gaps
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert dict(ours) == pytest.approx(dict(theirs))
    assert spans.figures(spans.table(st), 2) == {}
    for name in spans.FIGURES:
        assert spans.figure(name, {}, 2) is None


def test_kernels_belong_to_every_span_open_at_their_launch():
    tab = spans.table(spans.split(_fleet_events(), 1e-6))
    # each stage launched one kernel a frame of 10 * (i + 1) ns
    for i, name in enumerate(STAGES):
        assert tab[name]["count"] == 2
        assert tab[name]["device_s"] == pytest.approx(2 * 10 * (i + 1) / 1e9)
        assert tab[name]["host_s"] == pytest.approx(2 * 90 / 1e9)
    assert tab["step"]["device_s"] == pytest.approx(2 * 100 / 1e9)
    assert tab["multiseq.chunk"]["device_s"] == pytest.approx(220 / 1e9)
    assert tab["multiseq.upload"]["device_s"] == pytest.approx(20 / 1e9)


def test_idle_gaps_take_the_innermost_span_as_prefix():
    st = spans.split(_fleet_events(), 1e-6)
    labels = dict(spans.idle_labels(st, top=100))
    # the copy ends at 40, inside aten::copy_ in the upload
    assert labels == pytest.approx({
        "multiseq.upload/aten::copy_": 75e-9,
        "step.detect/no host activity": 180e-9,
        "track.match/no host activity": 160e-9,
        "track.pnp/no host activity": 140e-9,
        "track.keyframe/no host activity": 60e-9})
    tab = spans.table(st)
    assert spans.idle_s(st) == pytest.approx(615e-9)
    assert sum(v["idle_s"] for v in tab.values()) == pytest.approx(615e-9)
    assert {n: v["idle_s"] for n, v in tab.items() if v["idle_s"]} == \
        pytest.approx({"multiseq.upload": 75e-9, "step.detect": 180e-9,
                       "track.match": 160e-9, "track.pnp": 140e-9,
                       "track.keyframe": 60e-9})


def test_the_eleven_figures_on_a_hand_made_trace():
    fleet = spans.split(_fleet_events(), 1e-6)
    fig = spans.figures(spans.table(fleet), 2)
    assert fig == pytest.approx({
        "fleet.upload_host_ms": 50e-6 / 2, "fleet.draws_host_ms": 20e-6 / 2,
        "fleet.collect_host_ms": 70e-6 / 2, "step.dispatch_host_ms": 800e-6 / 2,
        "step.detect_ms": 20e-6 / 2, "step.match_ms": 40e-6 / 2,
        "step.pnp_ms": 60e-6 / 2, "step.keyframe_ms": 80e-6 / 2})
    ev = [Span("ba.global", 0, 1000)]
    corr = 1
    for it in range(3):
        base = 300 * it
        ev += [Span("ba.segment_sum", base + 10, base + 50)]
        ev += _launch("indexFuncLargeIndex", base + 20, base + 20, base + 40,
                      corr)
        ev += [Span("ba.stop_read", base + 100, base + 200),
               Ev("aten::_local_scalar_dense", base + 101, base + 199)]
        ev += _launch("Memcpy DtoH (Device -> Pinned)", base + 102,
                      base + 102, base + 105, corr + 1, "cudaMemcpyAsync")
        corr += 2
    gba = spans.table(spans.split(ev, 1e-6))
    fig = spans.figures(gba, 1)
    assert fig["gba.stop_reads_per_call"] == 3
    assert fig["gba.segment_sum_span_ms"] == pytest.approx(3 * 20e-6)
    # the gap after each read's copy (+105, up to the next iteration's
    # index_add at +320) opens in ba.stop_read; the last copy leaves none
    assert fig["gba.stop_read_idle_ms"] == pytest.approx(2 * 215e-6)
    assert gba["ba.segment_sum"]["idle_s"] == pytest.approx(3 * 62e-9)
    assert set(fig) == GBA


def test_clock_check_counts_kernels_that_start_before_their_launch():
    ev = _launch("k", 100, 90, 120, 1) + _launch("k", 200, 210, 220, 2)
    ev.append(Ev("orphan", 300, 310, CUDA, corr=77))
    st = spans.split(ev, 1e-6)
    assert st.launches == [100, 200, -1]
    assert spans.clock(st) == {"kernels_before_launch": 1, "launched": 2,
                               "offset_us": 0.01,
                               "offset_us_by_quarter": [0.0, 0.01, 0.0, 0.0]}


def test_idle_gaps_open_on_the_hosts_clock():
    """A session whose card events came out 10 ns early: the gap after the
    first kernel opens at 95 on the card's timestamps, 105 on the host's
    (the second kernel's launch at 300 less the gap's 195), inside the
    stop read [100, 200] and the first launch's call [100, 105]."""
    ev = ([Span("ba.stop_read", 100, 200)] + _launch("k", 100, 90, 95, 1)
          + _launch("k", 300, 290, 300, 2))
    st = spans.split(ev, 1e-6)
    assert spans.clock(st)["offset_us"] == 0.01
    assert spans.table(st)["ba.stop_read"]["idle_s"] == pytest.approx(195e-9)
    assert spans.idle_labels(st) == [("ba.stop_read/cudaLaunchKernel",
                                      pytest.approx(195e-9))]


@pytest.mark.parametrize("make", [tiny_fleet, tiny_gba])
def test_spans_of_the_tiny_cells_on_the_cpu(make, monkeypatch):
    for f in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, f, lambda *a, **k: None)
    cell = make()
    drv = R.make_driver(cell, 2 ** 31 + 5, device="cpu")
    drv.setup()
    work, units = drv.traced_work()
    tab = spans.table(spans.record(work))
    fig = spans.figures(tab, units)
    if cell["workload"]["name"] == "fr1_room.gba":
        assert set(fig) == GBA, fig
        assert tab["ba.global"]["count"] == units
        assert fig["gba.stop_reads_per_call"] >= 1
    else:
        assert set(fig) == FLEET, fig
        assert tab["step"]["count"] == units
        assert tab["multiseq.chunk"]["count"] * drv.chunk == units
        assert fig["fleet.collect_host_ms"] > 0


@pytest.mark.parametrize("make", [tiny_fleet, tiny_gba])
def test_span_report_on_the_tiny_cells_on_the_cpu(make, monkeypatch):
    """`span_report.report` with the benchmark's trace (which needs a card)
    replaced by an empty one."""
    from port_bench import span_report

    for f in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, f, lambda *a, **k: None)
    monkeypatch.setattr(trace, "record",
                        lambda work: (work(), trace.reduce([], [], 1.0))[1])
    cell = make()
    drv = R.make_driver(cell, 2 ** 31 + 9, device="cpu")
    drv.setup()
    r, = span_report.report(cell, drv, 1)["repeats"]
    json.dumps(r)
    assert r["span_in_device_ops"] == [] and r["clock"]["launched"] == 0
    if cell["workload"]["name"] == "fr1_room.gba":
        assert r["stop_reads"] == sum(r["lm_iterations"]) > 0
        assert len(r["lm_iterations"]) == r["units"]
        assert getattr(drv.gba, "__name__", "") == "global_ba"
    else:
        assert 0 < r["host_over_wall"] <= 1
        assert "stage_device_over_busy" not in r
