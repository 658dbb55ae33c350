"""The port's chunked path — `make_slam_scan`, `SlamSystem.process_chunk*`
with and without deferred pipelining, in-scan and boundary
relocalization, compaction on stale counters, `run(chunk=...)` — against
the JAX engine's chunked path on the CPU.

RANSAC draws are replayed as in tests/test_torch_engine.py: the JAX
engine's keys are recorded in the order the port draws them — for each
frame of a scan `k_track` (not on the bootstrap frame) and, on a lost
frame, the in-scan relocalizer's `top_k` splits of `k_reloc`; then the
verifications and boundary relocalizations of the chunk's bookkeeping.
Codes, decisions, match and inlier counts, keyframe slots, closures,
relocalizations and compactions must be equal, and poses agree within
1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import MapConfig, tiny_test_config
from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
from modular_slam_tpu.engine import _should_relocalize as jax_should_reloc
from modular_slam_tpu.engine import make_slam_scan as jax_make_slam_scan
from modular_slam_tpu.engine import make_slam_step as jax_make_slam_step
from modular_slam_tpu_torch.engine import SlamSystem, _should_relocalize
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.utils import state as port_state
from tests.test_torch_engine import (POSE_TOL, JaxKeyQueue, _CLOSURE_LOOP,
                                     _EveryTier, _assert_same_arena,
                                     _full_cfg, _plane_frames)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread for this file (see
    tests/test_torch_engine.py: the suite's worker processes share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one jitted JAX step and scan per configuration, shared by the JAX
# engines of this file (each engine would compile its own)
_JAX_FNS = {}


def _shared(kind, cfg, jsys, **kw):
    key = (kind, cfg, tuple(sorted(kw.items())))
    if key not in _JAX_FNS:
        if kind == "step":
            _JAX_FNS[key] = jax_make_slam_step(cfg, jsys.components)
        else:
            vocab = jsys._loop._vocab if kw["reloc"] else None
            _JAX_FNS[key] = jax_make_slam_scan(
                cfg, jsys.components, with_features=kw["feats"],
                reloc_vocab=vocab)
    return _JAX_FNS[key]


def _record(jsys, queue):
    """Give the JAX engine the shared step and scan, and wrap them, its
    verification and its relocalizer so that every RANSAC key lands in
    `queue` in the port's draw order.  -> the per-frame `relocalized`
    flags of its scans (the JAX engine keeps them only in the scan's
    output)."""
    cfg, lp = jsys.cfg, jsys._loop
    top_k = cfg.loop.top_k
    reloc = jsys.enable_relocalization and lp is not None
    feats = lp is not None
    step = _shared("step", cfg, jsys)
    scan = _shared("scan", cfg, jsys, reloc=reloc, feats=feats)
    relocalized = []

    def step_rec(arena, state, gray, depth, t, key):
        if int(arena.n_kf) > 0:            # the tracker draws (no bootstrap)
            queue.keys.append(key)
        return step(arena, state, gray, depth, t, key)

    def scan_rec(arena, state, *rest):
        keys = rest[-1]
        boot = int(arena.n_kf) == 0
        out = scan(arena, state, *rest)
        results = out[2][0] if feats else out[2]
        ok = np.asarray(results.tracking_ok)
        if reloc:
            relocalized.extend(np.asarray(results.relocalized).tolist())
        for i in range(keys.shape[0]):
            k_track, k_reloc = jax.random.split(keys[i])
            if not (boot and i == 0):
                queue.keys.append(k_track)
            if reloc and not ok[i]:
                for _ in range(top_k):
                    k_reloc, sub = jax.random.split(k_reloc)
                    queue.keys.append(sub)
        return out

    jsys._step, jsys._scan, jsys._scan_takes_db = step_rec, scan_rec, reloc
    if lp is not None:
        verify, rel = lp._verify_slots, lp._reloc

        def verify_rec(arena, scores, slots, feats_, key):
            queue.keys.extend(jax.random.split(key, slots.shape[0]))
            return verify(arena, scores, slots, feats_, key)

        def reloc_rec(arena, db, feats_, key):
            k = key
            for _ in range(top_k):
                k, sub = jax.random.split(k)
                queue.keys.append(sub)
            return rel(arena, db, feats_, key)

        lp._verify_slots, lp._reloc = verify_rec, reloc_rec
    return relocalized


def _pair(monkeypatch, cfg, **kw):
    """A JAX engine and a port engine on the CPU with the same switches,
    the JAX one with every global-BA tier installed and no background
    compile, its keys replayed to the port."""
    from modular_slam_tpu.loop.pipeline import LoopPipeline as JLoop

    monkeypatch.setattr(JLoop, "_compile_tier_async",
                        lambda self, tier, arena: None)
    monkeypatch.setattr(JLoop, "start_background_prewarm",
                        lambda self, arena: None)
    jsys = JaxSlamSystem(cfg, **kw)
    if jsys._loop is not None:
        jsys._loop._gba_tiers = _EveryTier(cfg)
    queue = JaxKeyQueue()
    relocalized = _record(jsys, queue)
    tsys = SlamSystem(cfg, device="cpu", sampler=queue, **kw)
    return jsys, tsys, queue, relocalized


def _assert_same_results(jsys, tsys, queue):
    assert not queue.keys, len(queue.keys)
    assert len(tsys.results) == len(jsys.results)
    for k, (jr, tr) in enumerate(zip(jsys.results, tsys.results)):
        for f in ("tracking_ok", "new_keyframe", "n_matches", "n_inliers",
                  "kf_slot"):
            assert int(getattr(tr, f)) == int(getattr(jr, f)), (k, f)
        for f in ("q", "t"):
            np.testing.assert_allclose(
                np.asarray(getattr(tr.pose, f)),
                np.asarray(getattr(jr.pose, f)), rtol=0, atol=POSE_TOL,
                err_msg=str(k))
    for (jt, _), (tt, _) in zip(jsys.trajectory, tsys.trajectory):
        assert jt == tt
    for f in ("n_loop_closures", "n_relocalizations", "n_compactions"):
        assert getattr(tsys, f) == getattr(jsys, f), f
    np.testing.assert_allclose(tsys.keyframe_trajectory(),
                               jsys.keyframe_trajectory(), rtol=0,
                               atol=POSE_TOL)


class _Writer:
    """A trajectory writer that keeps what `run` streams to it."""

    def __init__(self):
        self.rows = []

    def write(self, timestamp, pose):
        self.rows.append((timestamp, pose))


@pytest.mark.parametrize("preset", ["odometry", "slam"])
def test_run_chunked_matches_jax(monkeypatch, preset):
    """The odometry and slam presets through `run(chunk=4)` over ten
    frames: two chunks, then the last two frames one by one."""
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=10)
    jsys, tsys, queue, _ = _pair(monkeypatch, cfg,
                                 enable_backend=preset == "slam")
    jsys.run(iter(frames), chunk=4)          # JAX first: it records keys
    written = _Writer()
    traj = tsys.run(iter(frames), writer=written, chunk=4)
    assert len(traj) == 10 and written.rows == traj
    _assert_same_results(jsys, tsys, queue)
    kf = [bool(r.new_keyframe) for r in tsys.results]
    assert any(kf[1:8]) and not all(kf[1:8])   # both branches, in-chunk
    if preset == "slam":
        assert tsys._backend.n_submitted == jsys._backend.n_submitted \
            == sum(kf)


def test_chunk_grays_match_jax():
    """`process_chunk` converts rgb to luma with `rgb_to_luma`, as
    `process` does; the JAX chunk path uses a jitted tensordot.  On the CPU
    the two are equal bit for bit (tolerance 0)."""
    from modular_slam_tpu.types import LUMA_WEIGHTS
    from modular_slam_tpu_torch.io.tum import rgb_to_luma

    rgb = np.random.default_rng(3).integers(0, 256, (4, 48, 64, 3), np.uint8)
    w = jnp.array(LUMA_WEIGHTS, dtype=jnp.float32)
    want = jax.jit(lambda r: jnp.tensordot(r.astype(jnp.float32), w,
                                           axes=([-1], [0])))(rgb)
    np.testing.assert_array_equal(rgb_to_luma(torch.from_numpy(rgb)).numpy(),
                                  np.asarray(want))


def test_wire_and_device_chunks_match_jax(monkeypatch):
    """`process_chunk_wire` (8-bit luma, raw 16-bit depth, converted on
    the device) and `process_chunk_device` (frames already on the device)
    against the JAX engine's, deferred chunks of 4; then a frame through
    `process`, which finishes the pending chunk first."""
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=9)
    f = 1.0 / cfg.camera.depth_factor
    g8 = [np.clip(np.rint(r @ np.float32([0.299, 0.587, 0.114])), 0,
                  255).astype(np.uint8) for r, _, _ in frames[:8]]
    d16 = [np.rint(d * f).astype(np.uint16) for _, d, _ in frames[:8]]
    ts = [t for _, _, t in frames[:8]]
    jsys, tsys, queue, _ = _pair(monkeypatch, cfg, enable_backend=False,
                                 defer_chunk_sync=True)
    jsys.process_chunk_wire(g8[:4], d16[:4], ts[:4])
    jsys.process_chunk_device(
        jnp.asarray(np.stack(g8[4:]), jnp.float32),
        jnp.asarray(np.stack(d16[4:]), jnp.float32) * cfg.camera.depth_factor,
        ts[4:])
    jsys.process(*frames[8])
    tsys.process_chunk_wire(g8[:4], d16[:4], ts[:4])
    tsys.process_chunk_device(
        torch.from_numpy(np.stack(g8[4:])).to(torch.float32),
        torch.from_numpy(np.stack(d16[4:]).astype(np.float32))
        * cfg.camera.depth_factor, ts[4:])
    assert len(tsys.results) == 4                # the second chunk pends
    tsys.process(*frames[8])
    _assert_same_results(jsys, tsys, queue)
    assert all(bool(r.tracking_ok) for r in tsys.results)


def _there_and_back_and_there(cfg):
    """tests/test_torch_engine.py `_out_and_back`, then out again: 16
    frames of 0.25 m steps."""
    gen = PlaneSceneGenerator(cfg.camera, seed=34)
    out = gen.trajectory(6, step_t=(0.25, 0.0, 0.0))
    return list(gen.sequence(out + out[::-1][1:] + out[1:]))


def test_deferred_full_preset_closes_loops_and_compacts_like_jax(
        monkeypatch):
    """The full preset with `defer_chunk_sync=True`, five chunks of 3, an
    8-keyframe pool, out, back and out again: the verifications are
    parked at the keyframes and resolved at the next chunk's entry, each
    closure is followed by a burst of global-BA polishes, and the
    maintenance check runs on counters one chunk stale (with the last
    chunk's growth as margin), flushing the pending chunk before it
    compacts.  Every frame, the closures, the global BAs and the
    compactions equal JAX's, the arenas are equal after each compaction,
    and no closure is left pending after `flush_backend`."""
    cfg = _full_cfg(**_CLOSURE_LOOP)
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, max_keyframes=8))
    frames = _there_and_back_and_there(cfg)
    kw = dict(enable_backend=True, enable_loop_closure=True,
              enable_relocalization=True, defer_chunk_sync=True)
    jsys, tsys, queue, _ = _pair(monkeypatch, cfg, **kw)
    arenas = {"jax": [], "port": []}

    def snapshot(sys_, name, copy):
        compact = sys_._maybe_compact

        def wrapped(counters=None):
            done = compact(counters)
            if done:
                arenas[name].append(copy(sys_.arena))
            return done

        sys_._maybe_compact = wrapped

    snapshot(jsys, "jax", lambda a: jax.tree.map(np.array, a))
    snapshot(tsys, "port", lambda a: type(a)(*(x.clone() for x in a)))
    for sys_ in (jsys, tsys):              # JAX first: it records the keys
        for i in range(0, 15, 3):
            sys_.process_chunk(*zip(*frames[i:i + 3]))
        sys_.flush_backend()
    _assert_same_results(jsys, tsys, queue)
    assert not tsys._loop.has_pending_closure
    assert tsys.n_loop_closures >= 2
    assert [c[:2] for c in tsys._loop.closures] == [
        tuple(int(x) for x in c[:2]) for c in jsys._loop.closures]
    for tc, jc in zip(tsys._loop.closures, jsys._loop.closures):
        assert tc[2] == jc[2]
        np.testing.assert_allclose(tc[4], jc[4], rtol=0, atol=POSE_TOL)
    # the closures' global BAs and the polishes after them
    assert tsys._loop.n_global_ba == jsys._loop.n_global_ba \
        > tsys.n_loop_closures
    for f in ("_kf_counter", "_last_closure_at", "_n_edges", "_prev_kf"):
        assert getattr(tsys._loop, f) == getattr(jsys._loop, f), f
    assert tsys.n_compactions == jsys.n_compactions >= 2
    assert len(arenas["port"]) == len(arenas["jax"]) == tsys.n_compactions
    for k, (ja, ta) in enumerate(zip(arenas["jax"], arenas["port"])):
        _assert_same_arena(k, ja, ta)
    np.testing.assert_array_equal(tsys._loop.db.valid.numpy(),
                                  np.asarray(jsys._loop.db.valid))
    assert tsys._chunk_growth == jsys._chunk_growth
    assert tsys._prev_counters == tuple(jsys._prev_counters)


@pytest.mark.parametrize("defer,where", [(False, "in_scan"),
                                         (True, "boundary")])
def test_kidnap_in_a_later_chunk_relocalizes_like_jax(monkeypatch, defer,
                                                      where):
    """Twelve 0.5 m steps, then the first two views again, in chunks of
    7: the kidnap falls in the second chunk.  Synchronous, the first
    chunk's keyframes are in the database when the second chunk's scan
    starts, and the in-scan relocalizer rescues the kidnap frame.
    Deferred, the second scan runs before the first chunk's bookkeeping,
    the in-scan attempts find nothing, and the chunk boundary relocalizes.
    Per-frame `relocalized` flags, relocalizations and attempts equal
    JAX's."""
    cfg = _full_cfg()
    gen = PlaneSceneGenerator(cfg.camera, texture_ppm=250, seed=35)
    poses = gen.trajectory(12, step_t=(0.5, 0.0, 0.0))
    frames = list(gen.sequence(poses))
    frames = frames + frames[:2]
    jsys, tsys, queue, jrelocd = _pair(
        monkeypatch, cfg, enable_backend=False, enable_relocalization=True,
        defer_chunk_sync=defer)
    jsys.run(iter(frames), chunk=7)
    written = _Writer()
    tsys.run(iter(frames), writer=written, chunk=7)
    assert written.rows == tsys.trajectory and len(written.rows) == 14
    _assert_same_results(jsys, tsys, queue)
    trelocd = [bool(r.relocalized) for r in tsys.results]
    assert trelocd == [bool(x) for x in jrelocd]
    assert not tsys.results[12].tracking_ok            # the kidnap frame
    if where == "in_scan":
        # rescued in the scan; the chunk then ends on a weak frame after
        # a lost one, and the boundary relocalizes its last frame too
        assert trelocd[12] and tsys.results[13].tracking_ok
        assert tsys.n_relocalizations == jsys.n_relocalizations == 2
        assert tsys._loop.n_reloc_attempts == 2
    else:
        assert not any(trelocd)
        assert tsys.n_relocalizations == jsys.n_relocalizations == 1
        assert tsys._loop.n_reloc_attempts == 3    # 2 in-scan, 1 boundary
    np.testing.assert_allclose(tsys.state.pose.t.numpy(),
                               np.asarray(jsys.state.pose.t), rtol=0,
                               atol=POSE_TOL)
    assert int(tsys.state.ref_kf) == int(jsys.state.ref_kf)


def test_dropped_keyframe_counts_like_jax(monkeypatch):
    """A 2-keyframe pool, which eviction cannot shrink, drops every
    keyframe after the first two (slot K).  The loop pipeline runs on for
    it as in JAX — BoW query and verification on the clamped slot, the
    edge counter, `_prev_kf` and the cooldown's keyframe counter — while
    writing nothing that names slot K.  (Two candidates per query: the
    JAX `lax.top_k` takes no more than the pool holds.)"""
    cfg = tiny_test_config()
    cfg = cfg.replace(map=MapConfig(max_keyframes=2, max_landmarks=512,
                                    max_observations=2048),
                      loop=dataclasses.replace(cfg.loop, top_k=2))
    gen = PlaneSceneGenerator(cfg.camera, seed=2, texture_ppm=100.0)
    frames = list(gen.sequence(gen.trajectory(
        5, step_t=(0.005, 0.002, 0.0))))
    jsys, tsys, queue, _ = _pair(monkeypatch, cfg, enable_backend=False,
                                 enable_loop_closure=True,
                                 enable_relocalization=True)
    for k, f in enumerate(frames):
        jcode = jsys.process(*f)
        assert tsys.process(*f).name == jcode.name, k
        assert not queue.keys, (k, len(queue.keys))
        for a in ("_kf_counter", "_last_closure_at", "_n_edges",
                  "_prev_kf"):
            assert getattr(tsys._loop, a) == getattr(jsys._loop, a), (k, a)
        assert tsys._loop.closures == [] == jsys._loop.closures
    assert [int(r.kf_slot) for r in tsys.results][2:] == [2] * 3
    assert tsys.n_compactions == jsys.n_compactions >= 3
    edges = port_state.pose_graph_edges_to_numpy(tsys._loop.edges)
    for f in ("i", "j", "weight", "is_loop"):
        np.testing.assert_array_equal(
            edges[f], np.asarray(getattr(jsys._loop.edges, f)), err_msg=f)


@pytest.mark.parametrize("ok,n_inliers", [
    ([True, True, True], [300, 300, 300]),      # tracked throughout
    ([True, True, False], [300, 300, 0]),       # ends lost
    ([True, False, True], [300, 0, 12]),        # lost, weak end
    ([True, False, True], [300, 0, 400]),       # lost, recovered end
    ([False, False, False], [0, 0, 0]),
    ([False], [0]),
    ([True], [5]),
    ([False, True, True, True], [0, 31, 30, 29]),
])
def test_should_relocalize_matches_jax(ok, n_inliers):
    ok, n = np.asarray(ok), np.asarray(n_inliers, np.int32)
    for min_inliers in (30, 400):
        assert _should_relocalize(ok, n, min_inliers) \
            == jax_should_reloc(ok, n, min_inliers)


def test_scan_reads_nothing_back():
    """The chunked step with no relocalizer makes no host read: no scalar
    read, `nonzero` or boolean-mask gather is dispatched while a chunk
    (its bootstrap frame, keyframe frames and tracked frames) runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from modular_slam_tpu_torch.config import tiny_test_config as ttc
    from modular_slam_tpu_torch.engine import make_slam_scan
    from modular_slam_tpu_torch.frontend.tracker import initial_state
    from modular_slam_tpu_torch.map.arena import empty_arena
    from modular_slam_tpu_torch.utils.prng import prng_key, split

    reads = ("aten._local_scalar_dense", "aten.nonzero",
             "aten.masked_select", "aten.item")

    class HostReads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            if name.startswith(reads) or (
                    name.startswith("aten.index") and any(
                        isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in (args[1] if len(args) > 1
                                  and isinstance(args[1], (list, tuple))
                                  else ()))):
                self.seen.append(name)
            return func(*args, **(kwargs or {}))

    cfg = ttc()
    frames = _plane_frames(cfg, n=6)
    grays = torch.stack([torch.from_numpy(
        (f[0].astype(np.float32) @ np.float32([0.299, 0.587, 0.114])))
        for f in frames])
    depths = torch.stack([torch.from_numpy(f[1]) for f in frames])
    times = torch.tensor([f[2] for f in frames], dtype=torch.float32)
    scan = make_slam_scan(cfg, device="cpu")
    mode = HostReads()
    with mode:
        arena, state, res = scan(empty_arena(cfg.map), initial_state(),
                                 grays, depths, times,
                                 split(prng_key(0), len(frames)),
                                 bootstrap=True)
    assert mode.seen == []
    assert bool(res.tracking_ok.all())
    kf = res.new_keyframe.tolist()
    assert kf[0] and any(kf[1:]) and not all(kf[1:])
