"""The slice as a whole: the port's SlamSystem — the odometry preset, the
slam preset (local BA per keyframe) and the full preset (loop closure,
relocalization, map compaction) — against the JAX engine on the CPU,
frame by frame.

RANSAC draws are replayed: the port's sampler below repeats the JAX
engine's key schedule — PRNGKey(seed), one split per frame
(engine.py:312), `jax.random.choice` with the probabilities of
pnp.py:211-215 on the port's own `valid` mask — so both engines score the
same hypotheses.  Result codes, tracking and keyframe decisions, match and
inlier counts must then be equal, and poses agree within 1e-4.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import MapConfig, tiny_test_config
from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator as JaxScene
from modular_slam_tpu.frontend.tracker import TrackState as JTrackState
from modular_slam_tpu.geometry.se3 import Pose as JPose
from modular_slam_tpu.io import TumRgbdDataset
from modular_slam_tpu.map.arena import MapArena as JMapArena
from modular_slam_tpu_torch.engine import SlamSystem
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.utils import state as port_state

POSE_TOL = 1e-4
SAMPLE = os.path.join(os.path.dirname(__file__), "..", "data", "sample")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread for this file.  The suite runs in
    several worker processes that share the cores, and each process's
    default of one thread per core oversubscribes them: under five busy
    cores this file took 326 s with the default and 93 s with one thread.
    The count is restored for the files that run after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxKeyReplay:
    """RANSAC sampler replaying the JAX engine's draws.  `key` is the
    engine key before the next frame; the port calls the sampler once per
    tracked frame, and the JAX engine splits once per frame, so the
    bootstrap frame's split is skipped when starting from frame 0."""

    def __init__(self, key, at_first_frame=True):
        self.key = key
        if at_first_frame:
            self.key, _ = jax.random.split(self.key)

    def __call__(self, valid, n_hyp):
        self.key, sub = jax.random.split(self.key)
        v = jnp.asarray(valid.cpu().numpy())
        probs = v.astype(jnp.float32) + 1e-9
        probs = probs / jnp.sum(probs)
        idx = jax.random.choice(sub, v.shape[0], (n_hyp, 3), replace=True,
                                p=probs)
        return torch.from_numpy(np.array(idx)).long()


def _assert_same_frame(k, jsys, jcode, tsys, tcode):
    jr, tr = jsys.results[-1], tsys.results[-1]
    assert tcode.name == jcode.name, k
    for f in ("tracking_ok", "new_keyframe", "n_matches", "n_inliers",
              "kf_slot"):
        assert int(getattr(tr, f)) == int(getattr(jr, f)), (k, f)
    np.testing.assert_allclose(tr.pose.t.numpy(), np.asarray(jr.pose.t),
                               rtol=0, atol=POSE_TOL, err_msg=str(k))
    np.testing.assert_allclose(tr.pose.q.numpy(), np.asarray(jr.pose.q),
                               rtol=0, atol=POSE_TOL, err_msg=str(k))


def _run_both(cfg, frames, seed=0, backend=False):
    """Both engines over the frames; backend=True runs the slam preset
    (the JAX engine's default, local BA after every keyframe)."""
    from modular_slam_tpu_torch.models import make_pipeline

    jsys = JaxSlamSystem(cfg, seed=seed, enable_backend=backend)
    tsys = make_pipeline("slam" if backend else "odometry", cfg,
                         device="cpu",
                         sampler=JaxKeyReplay(jax.random.PRNGKey(seed)))
    for k, f in enumerate(frames):
        _assert_same_frame(k, jsys, jsys.process(*f), tsys, tsys.process(*f))
    return jsys, tsys


def _assert_same_keyframes(jsys, tsys):
    jk, tk = jsys.keyframe_trajectory(), tsys.keyframe_trajectory()
    assert jk.shape == tk.shape
    np.testing.assert_allclose(tk, jk, rtol=0, atol=POSE_TOL)


def test_numpy_scene_renders_the_jax_frames():
    cfg = tiny_test_config()
    jgen = JaxScene(cfg.camera, seed=5, texture_ppm=100.0)
    tgen = PlaneSceneGenerator(cfg.camera, seed=5, texture_ppm=100.0)
    jposes = (jgen.trajectory(3, step_t=(0.01, 0.004, -0.002),
                              step_rot=(0.01, 0.03, 0.02))
              + jgen.yaw_trajectory(2) + jgen.loop_trajectory(4)[1:2])
    tposes = (tgen.trajectory(3, step_t=(0.01, 0.004, -0.002),
                              step_rot=(0.01, 0.03, 0.02))
              + tgen.yaw_trajectory(2) + tgen.loop_trajectory(4)[1:2])
    for jp, tp in zip(jposes, tposes):
        np.testing.assert_array_equal(tp.q, np.asarray(jp.q))
        np.testing.assert_array_equal(tp.t, np.asarray(jp.t))
        for a, b in zip(tgen.render(tp), jgen.render(jp)):
            np.testing.assert_array_equal(a, b)


def test_odometry_matches_jax_on_plane_sequence_and_after_state_carry():
    cfg = tiny_test_config()
    frames = _plane_frames(cfg)
    jsys, tsys = _run_both(cfg, frames[:8])
    kf = [bool(r.new_keyframe) for r in tsys.results]
    assert all(bool(r.tracking_ok) for r in tsys.results)
    assert any(kf[1:]) and not all(kf[1:])  # both keyframe branches ran

    # carry the JAX engine's mid-sequence map and state into a fresh port
    # engine; one more frame must agree
    arena_np = jax.tree.map(np.asarray, jsys.arena)
    state_np = jax.tree.map(np.asarray, jsys.state)
    carried = SlamSystem(cfg, device="cpu", enable_backend=False,
                         sampler=JaxKeyReplay(jsys._key,
                                              at_first_frame=False))
    carried.arena = port_state.arena_from_numpy(arena_np)
    carried.state = port_state.track_state_from_numpy(state_np)
    _assert_same_frame(8, jsys, jsys.process(*frames[8]), carried,
                       carried.process(*frames[8]))

    # and the inverse conversions give back the JAX NamedTuples
    back = port_state.arena_to_numpy(carried.arena)
    JMapArena(**back)  # every field present
    st = port_state.track_state_to_numpy(carried.state)
    JTrackState(pose=JPose(**st.pop("pose")), **st)
    feats = port_state.features_to_numpy(carried.last_features)
    assert feats["descriptors"]["packed"].dtype == np.uint32
    np.testing.assert_array_equal(
        port_state.features_from_numpy(
            jax.tree.map(np.asarray, jsys.last_features)).descriptors.packed
        .numpy(), np.asarray(jsys.last_features.descriptors.packed)
        .view(np.int32))


def test_odometry_matches_jax_on_bundled_sample():
    """data/sample (16 rendered 320x240 frames), loaded by the JAX
    package's own loader; both engines get the same arrays."""
    ds = TumRgbdDataset(SAMPLE)
    cfg = tiny_test_config(240, 320).replace(
        camera=ds.camera,
        map=MapConfig(max_keyframes=16, max_landmarks=2048,
                      max_observations=8192))
    frames = list(ds)
    assert len(frames) == 16
    _, tsys = _run_both(cfg, frames)
    assert all(bool(r.tracking_ok) for r in tsys.results)
    assert tsys.n_keyframes > 2


def _plane_frames(cfg, n=9):
    gen = PlaneSceneGenerator(cfg.camera, seed=2, texture_ppm=100.0)
    poses = gen.trajectory(n, step_t=(0.005, 0.002, 0.0),
                           step_rot=(0.001, 0.002, 0.0))
    return list(gen.sequence(poses))


def test_slam_preset_matches_jax_on_plane_sequence():
    cfg = tiny_test_config()
    jsys, tsys = _run_both(cfg, _plane_frames(cfg), backend=True)
    n_kf = sum(bool(r.new_keyframe) for r in tsys.results)
    assert tsys._backend.n_submitted == n_kf > 2
    assert tsys._backend.n_merged == 0          # sync: merged inline
    _assert_same_keyframes(jsys, tsys)


def test_slam_preset_matches_jax_on_bundled_sample():
    ds = TumRgbdDataset(SAMPLE)
    cfg = tiny_test_config(240, 320).replace(
        camera=ds.camera,
        map=MapConfig(max_keyframes=16, max_landmarks=2048,
                      max_observations=8192))
    jsys, tsys = _run_both(cfg, list(ds), backend=True)
    assert all(bool(r.tracking_ok) for r in tsys.results)
    assert tsys._backend.n_submitted == tsys.n_keyframes > 2
    _assert_same_keyframes(jsys, tsys)


def test_async_backend_merges_everything_and_keeps_appended_slots():
    """ba_mode="async" on the CPU: every submitted window is merged by
    the end, and a solve merged after the map moved on leaves the slots
    appended meanwhile untouched (cf. tests/test_executor.py)."""
    from modular_slam_tpu_torch.backend.executor import BackendExecutor
    from modular_slam_tpu_torch.models import make_pipeline

    cfg = tiny_test_config()
    frames = _plane_frames(cfg)
    system = make_pipeline("slam", cfg, device="cpu", ba_mode="async")
    codes = [system.process(*f) for f in frames]
    system.flush_backend()
    assert all(c.name == "SUCCESS" for c in codes)
    ex = system._backend
    assert ex.mode == "async" and ex.n_submitted > 2
    assert ex.n_merged == ex.n_submitted and ex.n_dropped == 0
    assert system.keyframe_trajectory().shape == (system.n_keyframes, 8)
    system._backend.close()

    odo = SlamSystem(cfg, device="cpu", enable_backend=False)
    for f in frames[:5]:
        odo.process(*f)
    kf_before = odo.n_keyframes
    ex = BackendExecutor(cfg, mode="async", device="cpu")
    odo.arena, odo.state = ex.submit(odo.arena, odo.state, kf_before - 1)
    for f in frames[5:]:                 # track while the solve is out
        odo.process(*f)
    n_kf_mid, n_lm_mid = odo.n_keyframes, odo.n_landmarks
    assert n_kf_mid > kf_before
    mid = {f: getattr(odo.arena, f).clone() for f in ("kf_q", "kf_t")}
    arena, _, merged = ex.harvest(odo.arena, odo.state)
    assert merged and ex._pending is None
    assert (arena.n_kf.item(), arena.n_lm.item()) == (n_kf_mid, n_lm_mid)
    # keyframes appended after the snapshot are not in its window
    for f in ("kf_q", "kf_t"):
        assert torch.equal(getattr(arena, f)[kf_before:], mid[f][kf_before:])
    ex.close()


def test_unported_features_raise():
    """Every preset builds, an unknown one raises KeyError, and deferred
    closure decisions — the deferred chunk path's — are ported: with
    `defer_closure=True` a keyframe's verification is parked, not decided,
    until `resolve_pending`."""
    from modular_slam_tpu_torch.models import make_pipeline

    cfg = tiny_test_config()
    for name in ("odometry", "slam", "full"):
        assert isinstance(make_pipeline(name, cfg, device="cpu"), SlamSystem)
    full = make_pipeline("full", cfg, device="cpu")
    assert full.enable_loop_closure and full.enable_relocalization
    with pytest.raises(KeyError):
        make_pipeline("nonesuch", cfg, device="cpu")
    full.process(*_plane_frames(cfg, n=1)[0])
    lp = full._loop
    full.arena, full.state, closed = lp.on_new_keyframe(
        full.arena, full.state, 0, full.last_features, full._next_key(),
        defer_closure=True)
    assert not closed and lp.has_pending_closure
    assert lp._pending_verify[0][:2] == (lp._kf_counter, 0)
    full.arena, full.state, closed = lp.resolve_pending(full.arena,
                                                        full.state)
    assert not closed and not lp.has_pending_closure


def test_highwater_raises_until_lifecycle_is_ported():
    """The lifecycle is ported: a pool crossing the highwater mark is
    culled, evicted and compacted, as in the JAX engine, instead of
    raising.  24 landmarks hold fewer than one frame's keypoints, so every
    keyframe compacts."""
    base = tiny_test_config()
    cfg = base.replace(map=MapConfig(max_keyframes=16, max_landmarks=24,
                                     max_observations=2048))
    gen = PlaneSceneGenerator(cfg.camera, seed=2, texture_ppm=100.0)
    frames = list(gen.sequence(gen.trajectory(2, step_t=(0.005, 0.0, 0.0))))
    system = SlamSystem(cfg, device="cpu")
    assert [system.process(*f).name for f in frames] == ["SUCCESS"] * 2
    assert system.n_compactions == 2
    assert system.stats()["map_compactions"] == 2


# ---------------------------------------------------------------------------
# the full preset: loop closure, relocalization and map maintenance
# ---------------------------------------------------------------------------


class JaxKeyQueue:
    """RANSAC sampler replaying, in order, the keys the JAX engine drew
    while it processed the same frame (filled by `_record_keys`): the
    tracker's frame key, the `top_k` keys of a loop verification (one
    `split(key, top_k)`) and those of a relocalization attempt (the
    `lax.scan`'s splits).  The port draws in that order."""

    def __init__(self):
        self.keys = []

    def __call__(self, valid, n_hyp):
        v = jnp.asarray(valid.cpu().numpy())
        probs = v.astype(jnp.float32) + 1e-9
        probs = probs / jnp.sum(probs)
        idx = jax.random.choice(self.keys.pop(0), v.shape[0], (n_hyp, 3),
                                replace=True, p=probs)
        return torch.from_numpy(np.array(idx)).long()


class _EveryTier(dict):
    """The JAX pipeline's global-BA tier cache with every tier installed:
    a miss builds `make_global_ba_compact`, so no closure defers its
    global BA on a cold tier (which would depend on timing)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg

    def get(self, tier, default=None):
        from modular_slam_tpu.backend.ba import make_global_ba_compact

        if tier not in self:
            self[tier] = make_global_ba_compact(self.cfg, tier)
        return self[tier]


def _record_keys(jsys, queue):
    """Wrap the JAX engine's step, verification and relocalizer so that
    every RANSAC key they use lands in `queue`."""
    step, lp = jsys._step, jsys._loop
    verify, reloc = lp._verify_slots, lp._reloc
    top_k = jsys.cfg.loop.top_k

    def step_rec(arena, state, gray, depth, t, key):
        if int(arena.n_kf) > 0:            # the tracker draws (no bootstrap)
            queue.keys.append(key)
        return step(arena, state, gray, depth, t, key)

    def verify_rec(arena, scores, slots, feats, key):
        queue.keys.extend(jax.random.split(key, slots.shape[0]))
        return verify(arena, scores, slots, feats, key)

    def reloc_rec(arena, db, feats, key):
        k = key
        for _ in range(top_k):
            k, sub = jax.random.split(k)
            queue.keys.append(sub)
        return reloc(arena, db, feats, key)

    jsys._step, lp._verify_slots, lp._reloc = step_rec, verify_rec, reloc_rec


def _full_pair(monkeypatch, cfg, **kw):
    """A JAX SlamSystem and a port one on the CPU with the same switches;
    the JAX side with every global-BA tier installed and no background
    compiles, and its RANSAC keys replayed to the port."""
    from modular_slam_tpu.loop.pipeline import LoopPipeline as JLoop

    monkeypatch.setattr(JLoop, "_compile_tier_async",
                        lambda self, tier, arena: None)
    jsys = JaxSlamSystem(cfg, **kw)
    if jsys._loop is not None:
        jsys._loop._gba_tiers = _EveryTier(cfg)
    queue = JaxKeyQueue()
    _record_keys(jsys, queue)
    tsys = SlamSystem(cfg, device="cpu", sampler=queue, **kw)
    return jsys, tsys, queue


def _step_pair(k, jsys, tsys, queue, frame):
    _assert_same_frame(k, jsys, jsys.process(*frame), tsys,
                       tsys.process(*frame))
    assert not queue.keys, (k, len(queue.keys))
    for f in ("n_loop_closures", "n_relocalizations", "n_compactions"):
        assert getattr(tsys, f) == getattr(jsys, f), (k, f)


def _full_cfg(**loop):
    """tests/test_engine_full.py `_cfg()` (320x240), a keyframe every
    frame."""
    import dataclasses

    from modular_slam_tpu.config import (BackendConfig, CameraConfig,
                                         DetectorConfig, LoopConfig,
                                         PnpConfig, SlamConfig,
                                         TrackerConfig)

    return SlamConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                            width=320, height=240),
        detector=DetectorConfig(n_levels=4, max_keypoints=384),
        map=MapConfig(max_keyframes=32, max_landmarks=4096,
                      max_observations=16384),
        pnp=PnpConfig(n_hypotheses=64),
        backend=BackendConfig(max_iterations=8),
        tracker=TrackerConfig(new_keyframe_min_inliers=400),
        loop=dataclasses.replace(LoopConfig(), **loop))


def _out_and_back(cfg):
    """tests/test_engine_full.py:67: six 0.25 m steps out and back."""
    gen = PlaneSceneGenerator(cfg.camera, seed=34)
    out = gen.trajectory(6, step_t=(0.25, 0.0, 0.0))
    return list(gen.sequence(out + out[::-1][1:]))


_CLOSURE_LOOP = dict(min_gap_keyframes=4, min_score=0.10, min_inliers=25,
                     max_covis_overlap=1_000_000)


def test_full_preset_closes_the_same_loops_as_jax(monkeypatch):
    """The out-and-back closure (tests/test_engine_full.py:67) through
    both full engines: equal codes, closure pairs, global-BA runs and
    fused landmarks; frame and keyframe poses within 1e-4 after PGO,
    global BA, fusion and the post-fuse polish."""
    cfg = _full_cfg(**_CLOSURE_LOOP)
    jsys, tsys, queue = _full_pair(monkeypatch, cfg, enable_backend=True,
                                   enable_loop_closure=True,
                                   enable_relocalization=True)
    for k, f in enumerate(_out_and_back(cfg)):
        _step_pair(k, jsys, tsys, queue, f)
    assert tsys.n_loop_closures >= 1
    pairs = [c[:2] for c in tsys._loop.closures]
    assert pairs == [tuple(int(x) for x in c[:2])
                     for c in jsys._loop.closures]
    for tc, jc in zip(tsys._loop.closures, jsys._loop.closures):
        assert tc[2] == jc[2]                               # inliers
        np.testing.assert_allclose(tc[3], jc[3], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc[4], jc[4], rtol=0, atol=POSE_TOL)
    _assert_same_keyframes(jsys, tsys)     # flushes the post-fuse polish
    assert tsys._loop.n_global_ba == jsys._loop.n_global_ba >= 2
    assert tsys._loop.n_gba_deferred == jsys._loop.n_gba_deferred == 0
    ts, js = tsys.stats(), jsys.stats()
    assert ts == js, (ts, js)


def test_full_preset_relocalizes_like_jax(monkeypatch):
    """The kidnap of tests/test_engine_full.py:95: twelve 0.5 m steps,
    then the first view again; both engines relocalize on that frame to
    the same pose."""
    cfg = _full_cfg()
    gen = PlaneSceneGenerator(cfg.camera, texture_ppm=250, seed=35)
    poses = gen.trajectory(12, step_t=(0.5, 0.0, 0.0))
    frames = list(gen.sequence(poses))
    jsys, tsys, queue = _full_pair(monkeypatch, cfg, enable_backend=False,
                                   enable_relocalization=True)
    for k, f in enumerate(frames + frames[:1]):
        _step_pair(k, jsys, tsys, queue, f)
    assert tsys.n_relocalizations == jsys.n_relocalizations == 1
    assert tsys._loop.n_reloc_attempts == 1
    for f in ("q", "t"):
        np.testing.assert_allclose(
            getattr(tsys.state.pose, f).numpy(),
            np.asarray(getattr(jsys.state.pose, f)), rtol=0, atol=POSE_TOL)
    assert int(tsys.state.ref_kf) == int(jsys.state.ref_kf)
    assert float(np.linalg.norm(tsys.state.pose.t.numpy() - poses[0].t)) \
        < 0.05


def _assert_same_arena(k, jarena, tarena):
    """Slots, counters, incidence and descriptors equal; poses within
    1e-4, landmark positions within 1e-3 m."""
    t = port_state.arena_to_numpy(tarena)
    for f in JMapArena._fields:
        want = np.asarray(getattr(jarena, f))
        if f in ("kf_q", "kf_t"):
            np.testing.assert_allclose(t[f], want, rtol=0, atol=POSE_TOL,
                                       err_msg=f"{k} {f}")
        elif f == "lm_pos":
            np.testing.assert_allclose(t[f], want, rtol=0, atol=1e-3,
                                       err_msg=f"{k} {f}")
        else:
            np.testing.assert_array_equal(t[f], want, err_msg=f"{k} {f}")


def test_full_preset_compacts_like_jax(monkeypatch):
    """The out-and-back loop with an 8-keyframe pool: both engines cull,
    evict and compact at the same frames, leave equal arenas after each
    compaction, and close the same loops across the remapped slots."""
    import dataclasses

    cfg = _full_cfg(**_CLOSURE_LOOP)
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(
        cfg.map, max_keyframes=8))
    jsys, tsys, queue = _full_pair(monkeypatch, cfg, enable_backend=True,
                                   enable_loop_closure=True,
                                   enable_relocalization=True)
    compacted = 0
    for k, f in enumerate(_out_and_back(cfg)):
        _step_pair(k, jsys, tsys, queue, f)
        if tsys.n_compactions > compacted:
            compacted = tsys.n_compactions
            _assert_same_arena(k, jsys.arena, tsys.arena)
            np.testing.assert_array_equal(
                tsys._loop.db.valid.numpy(), np.asarray(jsys._loop.db.valid))
            assert tsys._loop._prev_kf == jsys._loop._prev_kf
    assert compacted >= 2 and tsys.n_loop_closures >= 1
    assert [c[:2] for c in tsys._loop.closures] == [
        tuple(int(x) for x in c[:2]) for c in jsys._loop.closures]
    edges = port_state.pose_graph_edges_to_numpy(tsys._loop.edges)
    for f in ("i", "j", "weight", "is_loop"):
        np.testing.assert_array_equal(
            edges[f], np.asarray(getattr(jsys._loop.edges, f)), err_msg=f)


@pytest.mark.parametrize("entry", [
    "SlamSystem", "make_slam_step", "make_pipeline", "make_pipeline_slam",
    "make_local_ba", "make_global_ba", "make_global_ba_compact",
    "BackendExecutor", "make_pipeline_full", "LoopPipeline",
    "make_slam_scan", "make_relocalizer"])
def test_entry_points_default_to_the_card(entry):
    """With no device the entry points take "cuda": on a machine with no
    CUDA device they raise instead of running on the CPU."""
    from modular_slam_tpu_torch.backend import ba
    from modular_slam_tpu_torch.backend.executor import BackendExecutor
    from modular_slam_tpu_torch.engine import make_slam_scan, make_slam_step
    from modular_slam_tpu_torch.loop.pipeline import LoopPipeline
    from modular_slam_tpu_torch.loop.relocalizer import make_relocalizer
    from modular_slam_tpu_torch.models import make_pipeline

    cfg = tiny_test_config()
    build = {"SlamSystem": lambda: SlamSystem(cfg),
             "make_slam_step": lambda: make_slam_step(cfg),
             "make_pipeline": lambda: make_pipeline("odometry", cfg),
             "make_pipeline_slam": lambda: make_pipeline("slam", cfg),
             "make_local_ba": lambda: ba.make_local_ba(cfg),
             "make_global_ba": lambda: ba.make_global_ba(cfg),
             "make_global_ba_compact": lambda: ba.make_global_ba_compact(
                 cfg, (16, 1024, 4096)),
             "BackendExecutor": lambda: BackendExecutor(cfg),
             "make_pipeline_full": lambda: make_pipeline("full", cfg),
             "LoopPipeline": lambda: LoopPipeline(cfg),
             "make_slam_scan": lambda: make_slam_scan(cfg),
             "make_relocalizer": lambda: make_relocalizer(cfg)}[entry]
    if torch.cuda.is_available():
        made = build()
        if isinstance(made, SlamSystem):
            assert made.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()


def test_slam_system_takes_jax_positional_order():
    """`SlamSystem(cfg, 3, False)` means seed 3 and no backend, as in the
    JAX engine; `device` and `sampler` are keyword-only."""
    cfg = tiny_test_config()
    jsys = JaxSlamSystem(cfg, 3, False)
    tsys = SlamSystem(cfg, 3, False, device="cpu")
    assert jsys.enable_backend is tsys.enable_backend is False
    np.testing.assert_array_equal(np.asarray(jsys._key),
                                  np.asarray(jax.random.PRNGKey(3)))
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))
    assert tsys.sampler is None
    jax_args = (3, False, 2, False, False, None, "async", True)
    full = SlamSystem(cfg, *jax_args, device="cpu")
    assert (full.ba_every, full.ba_mode, full.defer_chunk_sync) == (
        2, "async", True)
    with pytest.raises(TypeError):
        SlamSystem(cfg, *jax_args, "cpu")


def test_make_slam_step_takes_jax_positional_order():
    """`make_slam_step(cfg, None, device=...)` is the step of the keyword
    form: two frames (a bootstrap and a tracked one) give equal maps,
    states and results."""
    from modular_slam_tpu_torch.engine import make_slam_step
    from modular_slam_tpu_torch.frontend.tracker import initial_state
    from modular_slam_tpu_torch.io.tum import frame_to_device
    from modular_slam_tpu_torch.map.arena import empty_arena
    from modular_slam_tpu_torch.ops.pnp import MultinomialSampler

    cfg = tiny_test_config()
    gen = PlaneSceneGenerator(cfg.camera, seed=5, texture_ppm=100.0)
    frames = [frame_to_device(*gen.render(p), float(i), device="cpu")
              for i, p in enumerate(gen.trajectory(
                  2, step_t=(0.01, 0.004, 0.0)))]
    outs = []
    for step in (make_slam_step(cfg, None, device="cpu"),
                 make_slam_step(cfg, components=None, device="cpu")):
        arena, state = empty_arena(cfg.map), initial_state()
        sampler = MultinomialSampler(1)
        for fr in frames:
            arena, state, result, _ = step(arena, state, fr.gray, fr.depth,
                                           fr.timestamp, sampler)
        assert bool(result.tracking_ok)
        outs.append(jax.tree.leaves((arena, state, result)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
