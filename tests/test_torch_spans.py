"""The port's spans (modular_slam_tpu_torch/utils/profiling.py::span), on
the CPU.

Off, no range is opened.  On, under a CPU profiler, the tracked step's
stages, the multiseq chunk's upload, draws and collect, and global BA's
stop reads and segment sums appear as host ranges, once per (batched)
frame, chunk or LM iteration, and the outputs equal the profiler-off
run's bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modular_slam_tpu_torch.backend import ba as tba
from modular_slam_tpu_torch.backend.residuals import ObsData
from modular_slam_tpu_torch.config import BackendConfig, tiny_test_config
from modular_slam_tpu_torch.engine import make_slam_step
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.frontend.tracker import initial_state
from modular_slam_tpu_torch.geometry.camera import camera_from_config
from modular_slam_tpu_torch.io.tum import rgb_to_luma
from modular_slam_tpu_torch.map.arena import empty_arena
from modular_slam_tpu_torch.parallel.multiseq import MultiSequenceRunner
from modular_slam_tpu_torch.utils import profiling
from modular_slam_tpu_torch.utils.prng import prng_key, split

STAGES = ("step.detect", "track.match", "track.pnp", "track.keyframe")
CHUNK = ("multiseq.chunk", "multiseq.upload", "prng.uniforms",
         "multiseq.collect")


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One PyTorch intra-op thread, and vmap's per-example fallback an
    error (tests/test_torch_parallel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """Four frames of each of two sequences: grays, depths [4, 2, H, W],
    times [4, 2]."""
    cfg = tiny_test_config()
    grays, depths = [], []
    for b in range(2):
        gen = PlaneSceneGenerator(cfg.camera, seed=40 + b, texture_size=1024)
        poses = gen.trajectory(4, step_t=(0.004 * (1 - 2 * b), 0.002, 0.0))
        seq = list(gen.sequence(poses))
        grays.append(np.stack([rgb_to_luma(torch.from_numpy(f[0])).numpy()
                               for f in seq]))
        depths.append(np.stack([np.asarray(f[1], np.float32) for f in seq]))
    times = np.stack([[f[2] for f in seq]] * 2, axis=1).astype(np.float32)
    return (np.stack(grays, 1), np.stack(depths, 1), times)


def _spans(prof, names):
    """[(name, start ns, end ns)] of the profiled spans named in `names`
    (their ranges' names less `SPAN_PREFIX`), by start."""
    n = len(profiling.SPAN_PREFIX)
    ev = [(e.name()[n:], e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith(profiling.SPAN_PREFIX)
          and e.name()[n:] in names]
    return sorted(ev, key=lambda x: x[1])


def _track(frames, on_from=None):
    """The single-sequence step over the first sequence's frames, the
    profiler on from frame `on_from`; (outputs, profiler or None)."""
    grays, depths, times = frames
    cfg = tiny_test_config()
    step = make_slam_step(cfg, device="cpu")
    arena, state = empty_arena(cfg.map, "cpu"), initial_state("cpu")
    keys = split(prng_key(3), grays.shape[0])
    out, prof = [], None
    for i in range(grays.shape[0]):
        if i == on_from:
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.__enter__()
        arena, state, res, _ = step(
            arena, state, torch.from_numpy(grays[i, 0]),
            torch.from_numpy(depths[i, 0]), torch.tensor(times[i, 0]),
            keys[i], bootstrap=i == 0)
        out.append(res)
    if prof is not None:
        prof.__exit__(None, None, None)
    return [tuple(x for x in arena)] + [tuple(r.pose) + tuple(r[1:-1])
                                        for r in out], prof


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _equal(x, y)
        else:
            assert torch.equal(x, y)


def test_spans_off_open_no_range(frames, monkeypatch):
    opened = []
    real = profiling._range

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_range", counting)
    _track(frames)
    assert opened == []
    _track(frames, on_from=2)
    assert opened.count(profiling.SPAN_PREFIX + "track.pnp") == 2


def test_single_stream_stage_spans_in_order_and_outputs_unchanged(frames):
    off, _ = _track(frames)
    on, prof = _track(frames, on_from=1)
    _equal(off, on)
    spans = _spans(prof, STAGES)
    tracked = frames[0].shape[0] - 1
    assert [n for n, _, _ in spans] == list(STAGES) * tracked
    for (_, s0, e0), (_, s1, _) in zip(spans, spans[1:]):
        assert e0 <= s1


def _runner(frames, profiled_chunk=None):
    grays, depths, times = frames
    runner = MultiSequenceRunner(tiny_test_config(), batch=2, chunk=2,
                                 seed=7, device="cpu")
    prof = None
    for c in range(2):
        sl = slice(2 * c, 2 * c + 2)
        if c == profiled_chunk:
            prof = profile(activities=[ProfilerActivity.CPU])
            prof.__enter__()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            runner.process_chunk(grays[sl], depths[sl], times[sl])
        if c == profiled_chunk:
            prof.__exit__(None, None, None)
    return runner, prof


def test_batched_spans_once_per_batched_frame_and_chunk(frames):
    off, _ = _runner(frames)
    on, prof = _runner(frames, profiled_chunk=1)
    assert [len(t) for t in off.trajectories] == [4, 4]
    for a, b in zip(off.trajectories, on.trajectories):
        assert len(a) == len(b)
        for (ta, pa), (tb, pb) in zip(a, b):
            assert ta == tb and torch.equal(pa.q, pb.q)
            assert torch.equal(pa.t, pb.t)
    assert off.tracking_ok == on.tracking_ok
    _equal(tuple(off.arenas[0]), tuple(on.arenas[0]))
    spans = _spans(prof, STAGES + CHUNK + ("step",))
    names = [n for n, _, _ in spans]
    for n in CHUNK:
        assert names.count(n) == 1, (n, names)
    for n in STAGES + ("step",):
        assert names.count(n) == 2, (n, names)
    (_, c0, c1), = [s for s in spans if s[0] == "multiseq.chunk"]
    assert all(c0 <= s <= e <= c1 for _, s, e in spans)


def test_global_ba_stop_reads_and_segment_sums():
    rng = np.random.default_rng(0)
    K, L = 3, 24
    cam = camera_from_config(tiny_test_config().camera, "cpu")
    lm = torch.from_numpy(rng.uniform([-1, -1, 2], [1, 1, 4], (L, 3)))
    kf = torch.arange(K).repeat_interleave(L)
    lm_i = torch.arange(L).repeat(K)
    t_wc = torch.tensor([[0.0, 0, 0], [0.1, 0, 0], [0.2, 0.05, 0]],
                        dtype=torch.float64)
    q_wc = torch.tensor([[1.0, 0, 0, 0]] * K, dtype=torch.float64)
    obs = ObsData(kf=kf, lm=lm_i, p_obs=lm[lm_i] - t_wc[kf],
                  uv=torch.zeros(K * L, 2, dtype=torch.float64),
                  w=torch.ones(K * L, dtype=torch.float64))
    noisy = lm + torch.from_numpy(rng.normal(0, 0.02, (L, 3)))
    args = (cam, q_wc, t_wc + 0.01, noisy, obs,
            torch.arange(K) > 0, torch.ones(L, dtype=torch.bool),
            BackendConfig(max_iterations=12))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        *_, stats = tba.ba_core(*args, early_stop_rtol=1e-3)
    spans = _spans(prof, ("ba.stop_read", "ba.segment_sum"))
    names = [n for n, _, _ in spans]
    assert 0 < names.count("ba.stop_read") == stats.n_iterations
    assert names.count("ba.segment_sum") >= 4 * stats.n_iterations
