"""The port's loop detection (modular_slam_tpu_torch/loop/) against the
JAX package on the CPU: the vocabulary, the BoW database and its query,
geometric verification of a batch of candidates (one K2 launch on the
card; its plain version here), the relocalizer and the loop pipeline's
slot remap.

Tolerances: the codebook, the words, the histograms, the database rows,
the query slots (ties included) and the remaps are exact; BoW scores
within 1e-5; verification and relocalization give equal ok flags, slots
and inlier counts, and poses within 1e-4, with the JAX RANSAC draws
replayed through the port's sampler.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import (CameraConfig, DetectorConfig, MapConfig,
                                     PnpConfig, SlamConfig)
from modular_slam_tpu.loop import detector as jdet
from modular_slam_tpu.loop import vocab as jvocab
from modular_slam_tpu_torch.loop import detector as tdet
from modular_slam_tpu_torch.loop import vocab as tvocab
from modular_slam_tpu_torch.utils import state as port_state

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
POSE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread for this file (the suite's workers
    share the cores; see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _desc(n, seed):
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-1, 1], np.int8), size=(n, 256))


# ---------------------------------------------------------------------------
# vocabulary
# ---------------------------------------------------------------------------


def test_packaged_vocab_is_a_copy_of_the_jax_packages():
    port = os.path.join(ROOT, "modular_slam_tpu_torch", "data",
                        "vocab_1024_256.npz")
    jax_file = os.path.join(ROOT, "modular_slam_tpu", "data",
                            "vocab_1024_256.npz")
    with open(port, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    got = tvocab.load_trained_vocab(1024)
    np.testing.assert_array_equal(got, jvocab.load_trained_vocab(1024))
    assert got.dtype == np.int8 and got.shape == (1024, 256)
    # no packaged file of this size: the random-projection codebook
    np.testing.assert_array_equal(tvocab.load_trained_vocab(64),
                                  jvocab.load_trained_vocab(64))


def test_make_and_train_vocab_equal_jax():
    np.testing.assert_array_equal(tvocab.make_vocab(128),
                                  jvocab.make_vocab(128))
    d = _desc(600, 3)
    np.testing.assert_array_equal(tvocab.train_vocab(d, 64, iters=4),
                                  jvocab.train_vocab(d, 64, iters=4))
    with pytest.raises(ValueError):
        tvocab.train_vocab(d[:10], 64)


@pytest.mark.parametrize("vocab_size", [64, 1024])
def test_words_and_histogram_exact(vocab_size):
    """Integer similarities tie often against a 64-word codebook: the
    first index wins in both."""
    vocab = jvocab.load_trained_vocab(vocab_size)
    d = _desc(512, vocab_size)
    valid = np.random.default_rng(1).random(512) > 0.2
    jw = jvocab.descriptor_words(jnp.asarray(d), vocab)
    tw = tvocab.descriptor_words(_t(d), _t(vocab))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jh = jvocab.bow_histogram(jnp.asarray(d), jnp.asarray(valid), vocab)
    th = tvocab.bow_histogram(_t(d), _t(valid), _t(vocab))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    none = tvocab.bow_histogram(_t(d), torch.zeros(512, dtype=torch.bool),
                                _t(vocab))
    assert not none.any()


# ---------------------------------------------------------------------------
# database and query
# ---------------------------------------------------------------------------


def _databases(n_kf=10, K=16, V=64, dup=(2, 5, 7)):
    """The same BoW rows in a JAX and a port database; rows in `dup` hold
    identical histograms (exact score ties)."""
    vocab = jvocab.make_vocab(V)
    jdb = jdet.empty_database(K, V)
    tdb = tdet.empty_database(K, V)
    hists = []
    for k in range(n_kf):
        seed = dup[0] if k in dup else 100 + k
        h = jvocab.bow_histogram(jnp.asarray(_desc(40, seed)),
                                 jnp.ones(40, bool), vocab)
        hists.append(h)
        jdb = jdet.add_keyframe_bow(jdb, jnp.int32(k), h)
        tdet.add_keyframe_bow(tdb, k, _t(h))
    tdet.add_keyframe_bow(tdb, K, _t(hists[0]))          # dropped
    return jdb, tdb, hists


def test_database_rows_exact():
    jdb, tdb, _ = _databases()
    got = port_state.loop_database_to_numpy(tdb)
    np.testing.assert_array_equal(got["hists"], np.asarray(jdb.hists))
    np.testing.assert_array_equal(got["valid"], np.asarray(jdb.valid))
    back = port_state.loop_database_from_numpy(
        jax.tree.map(np.asarray, jdb))
    assert torch.equal(back.hists, tdb.hists)


@pytest.mark.parametrize("case", ["gap", "adaptive", "covis", "reloc",
                                  "ties"])
def test_query_candidates_match_jax(case):
    jdb, tdb, hists = _databases()
    q = hists[9]
    kw = dict(min_gap=3, top_k=5)
    slot = 9
    if case == "adaptive":
        kw = dict(min_gap=20, top_k=5, gap_floor=3, gap_fraction=0.3)
    elif case == "covis":
        covis = np.zeros(16, np.int32)
        covis[[1, 2, 5]] = [30, 5, 16]
        kw = dict(min_gap=3, top_k=8, covis_counts=covis, max_covis=15)
    elif case == "reloc":
        kw, slot = dict(min_gap=0, top_k=3), -10_000
    elif case == "ties":
        q, kw = hists[2], dict(min_gap=1, top_k=16)   # rows 2, 5, 7 tie
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    js, jslots = jdet.query_candidates(jdb, q, jnp.int32(slot), **jkw)
    ts, tslots = tdet.query_candidates(tdb, _t(q), slot, **tkw)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    assert (ts > -1).any()


# ---------------------------------------------------------------------------
# geometric verification and relocalization on a rendered scene
# ---------------------------------------------------------------------------


def _cfg():
    """tests/test_loop.py `_mini_map_with_features` (240x180)."""
    return SlamConfig(
        camera=CameraConfig(fx=200.0, fy=200.0, cx=119.5, cy=89.5,
                            width=240, height=180),
        detector=DetectorConfig(n_levels=3, max_keypoints=256),
        map=MapConfig(max_keyframes=8, max_landmarks=1024,
                      max_observations=4096),
        pnp=PnpConfig(n_hypotheses=64))


@pytest.fixture(scope="module")
def scene():
    """An arena of two keyframes — one at the query's place, one 42 m away
    — and the features of a query view 5 cm from the first, built with the
    port (detector and arena inserts are held to JAX by their own tests)
    and handed to both packages.  -> (cfg, JAX camera, JAX arena, JAX
    keyframe features, JAX query features, port arena, port query
    features, query position)."""
    from modular_slam_tpu.geometry.camera import camera_from_config
    from modular_slam_tpu.map.arena import MapArena as JArena
    from modular_slam_tpu.types import (Descriptors, Features, Keypoints)
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.geometry.camera import (
        backproject, camera_from_config as t_camera)
    from modular_slam_tpu_torch.geometry.se3 import Pose, pose_apply
    from modular_slam_tpu_torch.io.tum import frame_to_device
    from modular_slam_tpu_torch.map import (add_keyframe, add_landmarks,
                                            add_observations, empty_arena)
    from modular_slam_tpu_torch.ops.detector import detect

    cfg = _cfg()
    tcam = t_camera(cfg.camera)
    gen = PlaneSceneGenerator(cfg.camera, seed=8)

    def feats_at(t):
        q = np.array([0.99995, 0.0, 0.01, 0.0], np.float32)
        q = q / np.linalg.norm(q)
        pose = Pose(q=_t(q), t=_t(np.asarray(t, np.float32)))
        fr = frame_to_device(*gen.render(Pose(q=q, t=np.asarray(
            t, np.float32))), 0.0, device="cpu")
        return pose, detect(fr.gray, fr.depth, cfg.detector)

    def to_jax(f):
        d = port_state.features_to_numpy(f)
        return Features(
            keypoints=Keypoints(**{k: jnp.asarray(v) for k, v in
                                   d["keypoints"].items()}),
            descriptors=Descriptors(**{k: jnp.asarray(v) for k, v in
                                       d["descriptors"].items()}))

    arena = empty_arena(cfg.map)
    kf_feats = []
    for k, t in enumerate(([0.3, 0.1, 0.0], [30.0, 30.0, 0.0])):
        pose, feats = feats_at(t)
        kf_feats.append(to_jax(feats))
        arena, slot = add_keyframe(arena, pose, torch.tensor(float(k)))
        kps = feats.keypoints
        ok = kps.valid & (kps.depth > 0)
        pts = pose_apply(pose, backproject(tcam, kps.uv, kps.depth))
        arena, lm = add_landmarks(arena, pts, feats.descriptors.unpacked, ok)
        arena = add_observations(arena, slot, lm, kps.uv, kps.depth,
                                 feats.descriptors.unpacked, ok)
    true_t = np.array([0.35, 0.1, 0.0], np.float32)
    _, query = feats_at(true_t)
    jarena = JArena(**{k: jnp.asarray(v) for k, v in
                       port_state.arena_to_numpy(arena).items()})
    return (cfg, camera_from_config(cfg.camera), jarena, kf_feats,
            to_jax(query), arena, query, true_t)


class KeyReplay:
    """The port's sampler drawing with given JAX keys, in order (the
    probabilities of ops/pnp.py)."""

    def __init__(self, keys):
        self.keys = list(keys)

    def __call__(self, valid, n_hyp):
        v = jnp.asarray(valid.cpu().numpy())
        p = v.astype(jnp.float32) + 1e-9
        idx = jax.random.choice(self.keys.pop(0), v.shape[0], (n_hyp, 3),
                                replace=True, p=p / jnp.sum(p))
        return torch.from_numpy(np.array(idx)).long()


def test_geometric_verify_batch_matches_vmap(scene):
    """Three candidates in one call (the JAX pipeline's vmap): the query's
    own keyframe twice and the far one, which must fail."""
    from modular_slam_tpu_torch.geometry.camera import camera_from_config

    cfg, cam, arena, _, feats, tarena, tfeats, true_t = scene
    slots = jnp.array([0, 1, 0], jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    jok, jinl, jpose = jax.vmap(lambda c, k: jdet.geometric_verify(
        arena, c, feats, cam, cfg, k))(slots, keys)
    sampler = KeyReplay(keys)
    tok, tinl, tpose = tdet.geometric_verify(
        tarena, _t(slots), tfeats, camera_from_config(cfg.camera), cfg,
        sampler)
    assert not sampler.keys
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert tok.tolist() == [True, False, True]
    assert int(tinl[0]) >= cfg.loop.min_inliers
    ok = tok.numpy()
    for f in ("q", "t"):
        np.testing.assert_allclose(getattr(tpose, f).numpy()[ok],
                                   np.asarray(getattr(jpose, f))[ok],
                                   rtol=0, atol=POSE_TOL)
    np.testing.assert_allclose(tpose.t[0].numpy(), true_t, atol=1e-2)


@pytest.mark.parametrize("slot", [0, 1])
def test_geometric_verify_one_candidate_matches_jax(scene, slot):
    """A 0-d candidate slot, as the JAX function takes it: 0-d ok and
    inlier count and one pose, equal to JAX's on the same RANSAC draws,
    and to row 0 of the port's [1]-batched call."""
    from modular_slam_tpu_torch.geometry.camera import camera_from_config

    cfg, cam, arena, _, feats, tarena, tfeats, _ = scene
    key = jax.random.PRNGKey(5)
    jok, jinl, jpose = jax.jit(lambda a, c, f, k: jdet.geometric_verify(
        a, c, f, cam, cfg, k))(arena, jnp.int32(slot), feats, key)
    tcam = camera_from_config(cfg.camera)
    got = tdet.geometric_verify(tarena, torch.tensor(slot), tfeats, tcam,
                                cfg, KeyReplay([key]))
    assert isinstance(got, tdet.LoopVerification)
    assert got.ok.dim() == 0 and got.n_inliers.dim() == 0
    assert tuple(got.pose.q.shape) == (4,) and tuple(got.pose.t.shape) == (3,)
    assert bool(got.ok) == bool(jok) == (slot == 0)
    assert int(got.n_inliers) == int(jinl)
    if slot == 0:
        for f in ("q", "t"):
            np.testing.assert_allclose(getattr(got.pose, f).numpy(),
                                       np.asarray(getattr(jpose, f)),
                                       rtol=0, atol=POSE_TOL)
    row = tdet.geometric_verify(tarena, torch.tensor([slot]), tfeats, tcam,
                                cfg, KeyReplay([key]))
    assert bool(row.ok[0]) == bool(got.ok)
    assert int(row.n_inliers[0]) == int(got.n_inliers)
    assert torch.equal(row.pose.q[0], got.pose.q)
    assert torch.equal(row.pose.t[0], got.pose.t)


def test_relocalizer_matches_jax(scene):
    from modular_slam_tpu.loop.relocalizer import make_relocalizer as jmake
    from modular_slam_tpu_torch.loop.relocalizer import \
        make_relocalizer as tmake

    cfg, _, arena, kf_feats, feats, tarena, tfeats, true_t = scene
    vocab = jvocab.load_trained_vocab(cfg.loop.vocab_size)
    jdb = jdet.empty_database(cfg.map.max_keyframes, cfg.loop.vocab_size)
    for k, f in enumerate(kf_feats):
        h = jvocab.bow_histogram(f.descriptors.unpacked, f.keypoints.valid,
                                 vocab)
        jdb = jdet.add_keyframe_bow(jdb, jnp.int32(k), h)
    key = jax.random.PRNGKey(2)
    jok, jpose, jslot, jn = jmake(cfg)(arena, jdb, feats, key)

    keys, k = [], key
    for _ in range(cfg.loop.top_k):                 # the lax.scan's splits
        k, sub = jax.random.split(k)
        keys.append(sub)
    tdb = port_state.loop_database_from_numpy(jax.tree.map(np.asarray, jdb))
    tok, tpose, tslot, tn = tmake(cfg, _t(vocab))(tarena, tdb, tfeats,
                                                  KeyReplay(keys))
    assert bool(tok) == bool(jok) is True
    assert int(tslot) == int(jslot) == 0
    assert int(tn) == int(jn)
    for f in ("q", "t"):
        np.testing.assert_allclose(getattr(tpose, f).numpy(),
                                   np.asarray(getattr(jpose, f)), rtol=0,
                                   atol=POSE_TOL)
    np.testing.assert_allclose(tpose.t.numpy(), true_t, atol=1e-2)

    # an empty database: nothing to verify against
    empty = tdet.empty_database(cfg.map.max_keyframes, cfg.loop.vocab_size)
    tok, tpose, tslot, tn = tmake(cfg, _t(vocab))(
        tarena, empty, tfeats, KeyReplay(keys))
    assert not bool(tok) and int(tslot) == -1 and int(tn) == 0
    assert tpose.q.tolist() == [1.0, 0.0, 0.0, 0.0]


def test_remap_slots_matches_jax():
    """The pipeline's database rows and pose-graph edges after a
    compaction moved (and dropped) keyframe slots."""
    from modular_slam_tpu.backend.posegraph import add_edge as jadd_edge
    from modular_slam_tpu.geometry.se3 import Pose as JPose
    from modular_slam_tpu.loop.pipeline import LoopPipeline as JLoop
    from modular_slam_tpu.map.lifecycle import SlotRemaps as JRemaps
    from modular_slam_tpu_torch.loop.pipeline import LoopPipeline as TLoop
    from modular_slam_tpu_torch.map.lifecycle import SlotRemaps as TRemaps

    cfg = _cfg()
    K = cfg.map.max_keyframes
    jl, tl = JLoop(cfg), TLoop(cfg, device="cpu")
    jdb, _, _ = _databases(n_kf=7, K=K, V=cfg.loop.vocab_size, dup=(9,))
    jl.db = jdb
    rng = np.random.default_rng(4)
    edges = jl.edges
    for e, (i, j) in enumerate([(0, 1), (1, 2), (2, 3), (3, 5), (5, 6),
                                (6, 1)]):
        rel = JPose(q=jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                    t=jnp.asarray(rng.normal(size=3), jnp.float32))
        edges = jadd_edge(edges, jnp.int32(e), jnp.int32(i), jnp.int32(j),
                          rel, 1.0 + e, is_loop=e == 5)
    jl.edges = edges
    tl.db = port_state.loop_database_from_numpy(jax.tree.map(np.asarray, jdb))
    tl.edges = port_state.pose_graph_edges_from_numpy(
        jax.tree.map(np.asarray, edges))
    jl._prev_kf = tl._prev_kf = 6
    # keyframes 1 and 4 evicted, the rest moved down
    kf_map = np.array([0, K, 1, 2, K, 3, 4, 5, 6] + [K] * (K - 8),
                      np.int32)[:K + 1]
    kf_map[K] = K
    lm_map = np.arange(cfg.map.max_landmarks + 1, dtype=np.int32)
    jl.remap_slots(JRemaps(kf=jnp.asarray(kf_map), lm=jnp.asarray(lm_map)))
    tl.remap_slots(TRemaps(kf=_t(kf_map), lm=_t(lm_map)))
    got = port_state.loop_database_to_numpy(tl.db)
    for f in ("hists", "valid"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jl.db, f)))
    got = port_state.pose_graph_edges_to_numpy(tl.edges)
    for f in got:
        np.testing.assert_array_equal(got[f],
                                      np.asarray(getattr(jl.edges, f)))
    assert tl._prev_kf == jl._prev_kf == 4
    assert got["weight"][:6].tolist() == [0, 0, 3, 4, 5, 0]


def test_resolve_pending_drains_fifo_under_the_cooldown():
    """Queued closure decisions (the chunked path's deferred
    verifications) resolve in order, and an entry queued before an
    earlier one closed falls in that closure's cooldown — as in the JAX
    pipeline, both given the same queue and a stub decision."""
    from modular_slam_tpu.loop.pipeline import LoopPipeline as JLoop
    from modular_slam_tpu_torch.loop.pipeline import LoopPipeline as TLoop

    decided = {}
    for name, lp in (("jax", JLoop(_cfg())),
                     ("port", TLoop(_cfg(), device="cpu"))):
        seen = decided.setdefault(name, [])

        def finish(arena, state, kf_slot, *rest, lp=lp, seen=seen, **kw):
            seen.append(kf_slot)
            if kf_slot == 3:                     # this one closes
                lp._last_closure_at = lp._kf_counter
            return arena, state, kf_slot == 3

        lp._finish_closure = finish
        lp._kf_counter = 9
        lp._pending_verify = [(ord_, slot, None, None, None, None, None)
                              for ord_, slot in ((2, 1), (5, 3), (8, 4),
                                                 (13, 6))]
        assert lp.has_pending_closure
        _, _, closed = lp.resolve_pending("arena", "state")
        assert closed and not lp.has_pending_closure
    assert decided["port"] == decided["jax"] == [1, 3, 6]


def test_relocalizer_loads_the_packaged_vocab_by_default():
    """`make_relocalizer(cfg, device=...)` with no vocab takes JAX's
    default, the packaged codebook, onto the device; it relocalizes as the
    call that passes that codebook does (same draws), on a
    `tiny_test_config` map."""
    from modular_slam_tpu_torch.config import tiny_test_config
    from modular_slam_tpu_torch.engine import SlamSystem
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.loop.relocalizer import make_relocalizer
    from modular_slam_tpu_torch.loop.vocab import \
        load_trained_vocab as t_load_vocab
    from modular_slam_tpu_torch.ops.pnp import MultinomialSampler

    cfg = tiny_test_config()
    system = SlamSystem(cfg, 0, False, enable_relocalization=True,
                        device="cpu")
    gen = PlaneSceneGenerator(cfg.camera, seed=5, texture_ppm=100.0)
    for i, pose in enumerate(gen.trajectory(3, step_t=(0.01, 0.004, 0.0))):
        system.process(*gen.render(pose), float(i))
    packaged = t_load_vocab(cfg.loop.vocab_size)
    np.testing.assert_array_equal(
        packaged, jvocab.load_trained_vocab(cfg.loop.vocab_size))
    default = make_relocalizer(cfg, device="cpu")
    assert default.vocab.device.type == "cpu"
    np.testing.assert_array_equal(default.vocab.numpy(), packaged)
    given = make_relocalizer(cfg, _t(packaged))
    args = (system.arena, system._loop.db, system.last_features)
    got = default(*args, MultinomialSampler(4))
    ref = given(*args, MultinomialSampler(4))
    assert bool(got[0]) and int(got[2]) >= 0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="device"):
        make_relocalizer(cfg, _t(packaged), device="meta")


def test_pending_global_ba_takes_jax_wait_argument(monkeypatch):
    """`maybe_run_pending_gba(arena, state, kf_slot, wait, counters)`: a
    JAX-style fourth argument is `wait` (nothing to wait for in the port),
    and `counters` comes fifth."""
    from modular_slam_tpu_torch.config import tiny_test_config
    from modular_slam_tpu_torch.loop.pipeline import LoopPipeline

    lp = LoopPipeline(tiny_test_config(), False, device="cpu")
    seen = []

    def tier_for(arena, counters):
        seen.append(counters)
        return (16, 512, 2048), counters

    monkeypatch.setattr(lp, "_tier_for", tier_for)
    monkeypatch.setattr(lp, "_gba_for", lambda tier: None)
    monkeypatch.setattr(lp, "_exec_global_ba",
                        lambda arena, state, kf_slot, gba: ("ran", kf_slot))
    assert lp.maybe_run_pending_gba("arena", "state", 3, True) == (
        "arena", "state")                      # nothing pending
    for wait in (True, False):
        lp._gba_pending = True
        assert lp.maybe_run_pending_gba("arena", "state", 3, wait,
                                        (2, 40, 90)) == ("ran", 3)
        assert not lp._gba_pending
    lp._gba_pending = True
    lp.maybe_run_pending_gba("arena", "state", 3, True)
    assert seen == [(2, 40, 90), (2, 40, 90), None]
