"""Device grids and multi-sequence tracking (modular_slam_tpu_torch.parallel)
against the JAX package's (modular_slam_tpu/parallel), on the CPU.

The batched step and scan of the port run B sequences through one
`torch.func.vmap` of the single-sequence step, with vmap's per-example
fallback turned into an error, so every op of the step batches.  They
are held against JAX's `make_batch_slam_scan` (one module-scoped run)
on JAX's keys, against the port's own single-sequence scan on the same
keys, and on the op count: a batch of 4 dispatches no more than 1.2
times the ops of a batch of 1.  `MultiSequenceRunner` from a seed is
held against JAX's runner from that seed.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from modular_slam_tpu.config import tiny_test_config as jax_tiny_config
from modular_slam_tpu.parallel import dp as jdp
from modular_slam_tpu.parallel import mesh as jmesh
from modular_slam_tpu.parallel.multiseq import \
    MultiSequenceRunner as JaxMultiSequenceRunner
from modular_slam_tpu.parallel.multiseq import \
    scaling_efficiency as jax_scaling_efficiency
from modular_slam_tpu_torch.config import (CameraConfig, DetectorConfig,
                                           MapConfig, PnpConfig, SlamConfig,
                                           tiny_test_config)
from modular_slam_tpu_torch.engine import make_slam_scan
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.frontend.tracker import initial_state
from modular_slam_tpu_torch.io.tum import rgb_to_luma
from modular_slam_tpu_torch.map.arena import empty_arena
from modular_slam_tpu_torch.ops import fast as tfast
from modular_slam_tpu_torch.ops import match as tmatch
from modular_slam_tpu_torch.parallel import (make_batch_slam_scan,
                                             make_batch_slam_step,
                                             make_kf_mesh, make_mesh)
from modular_slam_tpu_torch.parallel.dp import make_batch_init, tree_map
from modular_slam_tpu_torch.parallel.multiseq import (MultiSequenceRunner,
                                                      scaling_efficiency)
from modular_slam_tpu_torch.utils.prng import prng_key, split

B, C = 4, 6
POSE_TOL = 1e-4          # against JAX (the engine tests' tolerance)
SELF_TOL = 1e-5          # batched against the port's single sequence
CPUS = [torch.device("cpu")]
FIELDS = ("tracking_ok", "new_keyframe", "n_matches", "n_inliers", "kf_slot")


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """One PyTorch intra-op thread (see tests/test_torch_engine.py), and
    vmap's per-example fallback an error for the whole file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch._C._functorch._set_vmap_fallback_enabled(False)
    yield
    torch._C._functorch._set_vmap_fallback_enabled(True)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """B sequences with divergent trajectories (own textures, step
    directions and sizes) -> grays, depths [C, B, H, W], times [C, B],
    ground-truth positions [C, B, 3]."""
    cfg = tiny_test_config()
    grays, depths, gts = [], [], []
    for b in range(B):
        gen = PlaneSceneGenerator(cfg.camera, seed=100 + b,
                                  texture_ppm=100.0, texture_size=2048)
        sign = 1.0 if b % 2 == 0 else -1.0
        poses = gen.trajectory(
            C, step_t=(sign * (0.004 + 0.002 * b), 0.003 * sign, 0.001 * b),
            step_rot=(0.0005 * b, 0.001 * sign, 0.0))
        frames = list(gen.sequence(poses))
        grays.append(np.stack([rgb_to_luma(torch.from_numpy(f[0])).numpy()
                               for f in frames]))
        depths.append(np.stack([f[1] for f in frames]))
        gts.append(np.stack([p.t for p in poses]))
    times = np.tile(np.arange(C, dtype=np.float32)[:, None], (1, B)) / 30.0
    return (cfg, np.stack(grays, 1), np.stack(depths, 1).astype(np.float32),
            times, np.stack(gts, 1))


@pytest.fixture(scope="module")
def jax_run(scenes):
    """JAX's batched scan over the scenes, once for the file."""
    _, grays, depths, times, _ = scenes
    cfg = jax_tiny_config()
    mesh = jmesh.make_mesh(seq=1, obs=1, devices=jax.devices()[:1])
    keys = jax.random.split(jax.random.PRNGKey(7), C * B).reshape(C, B, 2)
    arenas, states = jdp.make_batch_init(cfg, mesh, B)
    arenas, states, res = jdp.make_batch_slam_scan(cfg, mesh)(
        arenas, states, jnp.asarray(grays), jnp.asarray(depths),
        jnp.asarray(times), keys)
    return keys, jax.tree.map(np.asarray, arenas), jax.tree.map(np.asarray,
                                                                res)


def _torch(scenes):
    _, grays, depths, times, _ = scenes
    return (torch.from_numpy(grays), torch.from_numpy(depths),
            torch.from_numpy(times))


def _cat(arenas):
    """Per-row stacked arenas -> one [B] counter each."""
    return {k: torch.cat([getattr(a, k) for a in arenas]).numpy()
            for k in ("n_kf", "n_lm", "n_obs")}


def _assert_like_jax(res, arenas, jres, jarenas):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f).numpy(),
                                      getattr(jres, f), err_msg=f)
    np.testing.assert_allclose(res.pose.t.numpy(), jres.pose.t, rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(res.pose.q.numpy(), jres.pose.q, rtol=0,
                               atol=POSE_TOL)
    for k, v in _cat(arenas).items():
        np.testing.assert_array_equal(v, getattr(jarenas, k), err_msg=k)


def test_mesh_shapes_and_errors():
    """As tests/test_parallel.py::test_mesh_creation, on a grid of
    repeated CPU devices, and the same errors as the JAX grids."""
    eight = CPUS * 8
    m = make_mesh(seq=2, obs=4, devices=eight)
    assert m.shape == {"seq": 2, "obs": 4}
    assert make_mesh(seq=1, devices=eight).shape["obs"] == 8
    assert make_kf_mesh(kf=4, devices=eight).shape == {"kf": 4, "obs": 2}
    jdevs = jax.devices()
    for fn, jfn, kw in ((make_mesh, jmesh.make_mesh, {"seq": 3}),
                        (make_mesh, jmesh.make_mesh, {"seq": 2, "obs": 3}),
                        (make_kf_mesh, jmesh.make_kf_mesh, {"kf": 3}),
                        (make_kf_mesh, jmesh.make_kf_mesh,
                         {"kf": 4, "obs": 4})):
        with pytest.raises(ValueError) as want:
            jfn(devices=jdevs, **kw)
        with pytest.raises(ValueError) as got:
            fn(devices=eight, **kw)
        assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiSequenceRunner(tiny_test_config(), batch=2)


def test_batch_splits_along_the_named_axis():
    """`axis` picks the grid axis the batch splits over ("seq", the rows,
    by default: the split of a grid of two rows); an axis the grid lacks
    raises ValueError, as JAX's `P(axis)` does."""
    from modular_slam_tpu_torch.parallel.dp import row_groups

    cfg = tiny_test_config()
    mesh = make_mesh(seq=2, obs=4, devices=CPUS * 8)
    assert [sl for _, sl in row_groups(mesh, 8)] == [slice(0, 4),
                                                     slice(4, 8)]
    assert [sl for _, sl in row_groups(mesh, 8, "obs")] == [
        slice(2 * g, 2 * g + 2) for g in range(4)]
    arenas, states = make_batch_init(cfg, mesh, 8, "obs")
    assert [a.n_kf.shape[0] for a in arenas] == [2] * 4
    assert [s.lost.shape[0] for s in states] == [2] * 4
    for fn, args in ((make_batch_init, (cfg, mesh, 8)),
                     (make_batch_slam_step, (cfg, mesh)),
                     (make_batch_slam_scan, (cfg, mesh))):
        with pytest.raises(ValueError, match="nope"):
            fn(*args, axis="nope")
    with pytest.raises(ValueError, match="nope"):
        jdp.make_batch_init(jax_tiny_config(),
                            jmesh.make_mesh(seq=1, devices=jax.devices()),
                            2, axis="nope")


def test_batched_scan_matches_jax(scenes, jax_run):
    keys, jarenas, jres = jax_run
    cfg = scenes[0]
    mesh = make_mesh(seq=1, devices=CPUS)
    arenas, states = make_batch_init(cfg, mesh, B)
    arenas, states, res = make_batch_slam_scan(cfg, mesh)(
        arenas, states, *_torch(scenes), np.asarray(keys), bootstrap=True)
    assert res.tracking_ok.all()
    _assert_like_jax(res, arenas, jres, jarenas)
    # the sequences follow their own ground truths (the bound of
    # tests/test_parallel.py::test_dp_multiframe_matches_single_device)
    gt = scenes[4]
    assert np.linalg.norm(res.pose.t.numpy() - gt, axis=-1).max() < 0.12


def test_batched_step_on_a_grid_of_two_rows_matches_jax(scenes, jax_run):
    """The per-frame batched step with the batch split over two grid
    rows (two groups of 2) gives JAX's scan, frame by frame."""
    keys, jarenas, jres = jax_run
    cfg = scenes[0]
    mesh = make_mesh(seq=2, devices=CPUS * 2)
    arenas, states = make_batch_init(cfg, mesh, B)
    assert [a.n_kf.shape[0] for a in arenas] == [2, 2]
    step = make_batch_slam_step(cfg, mesh)
    grays, depths, times = _torch(scenes)
    results = []
    for i in range(C):
        arenas, states, r = step(arenas, states, grays[i], depths[i],
                                 times[i], np.asarray(keys[i]),
                                 bootstrap=i == 0)
        results.append(r)
    res = tree_map(lambda *xs: torch.stack(xs), *results)
    _assert_like_jax(res, arenas, jres, jarenas)


def test_batched_scan_equals_single_sequence_scans(scenes):
    """Sequence b of the batch tracks as the port's single-sequence scan
    on sequence b's keys: equal flags, counts and slots."""
    cfg = scenes[0]
    grays, depths, times = _torch(scenes)
    keys = split(prng_key(3), C * B).reshape(C, B, 2)
    mesh = make_mesh(seq=1, devices=CPUS)
    arenas, states = make_batch_init(cfg, mesh, B)
    arenas, states, res = make_batch_slam_scan(cfg, mesh)(
        arenas, states, grays, depths, times, keys, bootstrap=True)
    single = make_slam_scan(cfg, device="cpu")
    for b in range(B):
        a1, _, r1 = single(empty_arena(cfg.map), initial_state(),
                           grays[:, b], depths[:, b], times[:, b],
                           keys[:, b], bootstrap=True)
        for f in FIELDS:
            assert torch.equal(getattr(r1, f), getattr(res, f)[:, b]), (b, f)
        torch.testing.assert_close(r1.pose.t, res.pose.t[:, b], rtol=0,
                                   atol=SELF_TOL)
        torch.testing.assert_close(r1.pose.q, res.pose.q[:, b], rtol=0,
                                   atol=SELF_TOL)
        for k in ("n_kf", "n_lm", "n_obs"):
            assert int(getattr(a1, k)) == int(getattr(arenas[0], k)[b]), k
        assert torch.equal(a1.inc, arenas[0].inc[b])


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_batch_of_four_dispatches_as_few_ops_as_a_batch_of_one(scenes):
    cfg = scenes[0]
    grays, depths, times = _torch(scenes)
    counts = {}
    for n in (1, 4):
        mesh = make_mesh(seq=1, devices=CPUS)
        arenas, states = make_batch_init(cfg, mesh, n)
        step = make_batch_slam_step(cfg, mesh)
        keys = split(prng_key(n), 2 * n).reshape(2, n, 2)
        arenas, states, _ = step(arenas, states, grays[0, :n], depths[0, :n],
                                 times[0, :n], keys[0], bootstrap=True)
        with _OpCount() as ops:
            arenas, states, r = step(arenas, states, grays[1, :n],
                                     depths[1, :n], times[1, :n], keys[1])
        assert r.tracking_ok.all()
        counts[n] = ops.n
    assert counts[4] <= 1.2 * counts[1], counts


def _small_cfg():
    """tests/test_engine_tracking.py::_small_cfg."""
    return SlamConfig(
        camera=CameraConfig(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                            width=320, height=240),
        detector=DetectorConfig(n_levels=4, max_keypoints=384),
        map=MapConfig(max_keyframes=32, max_landmarks=4096,
                      max_observations=16384),
        pnp=PnpConfig(n_hypotheses=64),
    )


def test_multiseq_runner_tracks_independent_sequences():
    """tests/test_multiseq.py::test_multiseq_runner_tracks_independent_
    sequences on the port, with chunks of 3 (a whole chunk and one of a
    single frame); textures of 2048 px (5 m at 400 px/m)
    to save the 4096 px ones' making."""
    cfg = _small_cfg()
    runner = MultiSequenceRunner(cfg, batch=4, chunk=3, device="cpu")
    seqs = []
    steps = [(0.02, 0, 0), (0, 0.02, 0), (-0.02, 0, 0), (0, -0.02, 0)]
    for b in range(4):
        gen = PlaneSceneGenerator(cfg.camera, seed=70 + b,
                                  texture_size=2048)
        poses = gen.trajectory(4, step_t=steps[b])
        seqs.append(list(gen.sequence(poses)))

    report = runner.run(seqs)
    assert report["frames_per_sequence"] == 4
    assert report["total_frames"] == 16
    assert all(all(ok) for ok in runner.tracking_ok)
    ends = [tr[-1][1].t.numpy() for tr in runner.trajectories]
    np.testing.assert_allclose(ends[0], [0.06, 0, 0], atol=0.02)
    np.testing.assert_allclose(ends[1], [0, 0.06, 0], atol=0.02)
    np.testing.assert_allclose(ends[2], [-0.06, 0, 0], atol=0.02)
    np.testing.assert_allclose(ends[3], [0, -0.06, 0], atol=0.02)


def test_scaling_efficiency_formula():
    assert scaling_efficiency(16.0, 10.0, 2) == 0.8
    assert scaling_efficiency(7.0, 3.0, 3) == jax_scaling_efficiency(7.0, 3.0,
                                                                     3)


class _Info:
    def __init__(self, batch_size):
        self.batch_size = batch_size


@pytest.fixture
def plain_ops(monkeypatch):
    """The operators of K1, K2 and the merge with their CUDA bodies
    swapped for their plain versions, which record each call -> (calls,
    the operators as the vmap rules find them unpatched)."""
    calls = []
    real = (tfast._fast_score_levels_op, tmatch._hamming_2nn_splits_op,
            tmatch._hamming_merge_op)

    def fast_plain(levels):
        calls.append(("K1", [tuple(x.shape) for x in levels]))
        return [tfast.fast_score_plain(x) for x in levels]

    def splits_plain(q, t, tv):
        calls.append(("K2", tuple(q.shape), tuple(t.shape), tuple(tv.shape)))
        return tmatch.hamming_2nn_splits_plain(q, t, tv, 1)

    def merge_plain(best, idx, second, qv, max_hamming, lowe_ratio):
        calls.append(("merge", tuple(best.shape), tuple(qv.shape)))
        b, i, s = tmatch.merge_tiles(best, idx, second)
        m = tmatch._ratio_test(b, s, i, qv, tiny_test_config().matcher)
        return m.lm_slot, m.distance, m.valid

    monkeypatch.setattr(tfast, "_fast_score_levels_op", fast_plain)
    monkeypatch.setattr(tmatch, "_hamming_2nn_splits_op", splits_plain)
    monkeypatch.setattr(tmatch, "_hamming_merge_op", merge_plain)
    return calls, real


def _pm1(rng, shape):
    return torch.from_numpy((rng.integers(0, 2, shape) * 2 - 1)
                            .astype(np.int8))


def _vmapped_match(real, q, qv, t, tv):
    cfg = tiny_test_config().matcher

    def one(q, qv, t, tv):
        best, idx, second = real[1](q, t, tv)
        return real[2](best, idx, second, qv, float(cfg.max_hamming),
                       float(cfg.lowe_ratio))

    in_dims = tuple(0 if x.dim() == d + 1 else None
                    for x, d in zip((q, qv, t, tv), (2, 1, 2, 1)))
    return torch.func.vmap(one, in_dims=in_dims)(q, qv, t, tv), cfg


def test_kernel_vmap_rules_launch_once_for_the_batch(plain_ops):
    """Under torch.func.vmap the operators of K1, K2 and the merge reach
    their vmap rules, which call the operator once with the batch at dim
    0 (an operand not vmapped shared): here the operators' CUDA bodies
    are swapped for their plain versions, which record each call."""
    calls, real = plain_ops
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.uniform(0, 255, (3, h, w)).astype(
        np.float32)) for h, w in ((20, 24), (17, 20))]
    got = torch.func.vmap(lambda a, b: real[0]([a, b]))(*imgs)
    assert calls == [("K1", [(3, 20, 24), (3, 17, 20)])]
    for g, img in zip(got, imgs):
        assert torch.equal(g, tfast.fast_score_plain(img))

    calls.clear()
    q = _pm1(rng, (3, 40, 256))
    t = _pm1(rng, (300, 256))
    qv = torch.from_numpy(rng.random((3, 40)) > 0.1)
    tv = torch.from_numpy(rng.random(300) > 0.2)
    (lm, dist, ok), cfg = _vmapped_match(real, q, qv, t, tv)
    assert calls == [("K2", (3, 40, 256), (300, 256), (300,)),
                     ("merge", (3, 3, 40), (3, 40))]
    want = tmatch.match_descriptors_plain(q, qv, t, tv, cfg)
    assert torch.equal(ok, want.valid)
    assert torch.equal(lm[ok], want.lm_slot[ok])
    assert torch.equal(dist[ok], want.distance[ok])


def test_k2_vmap_rule_with_a_train_operand_per_sequence(plain_ops):
    """The multiseq path's form: queries, landmark rows and both masks
    per sequence reach K2 and the merge as one batched call each, and
    sequence b's matches equal the plain matcher's on b alone."""
    calls, real = plain_ops
    rng = np.random.default_rng(1)
    q, t = _pm1(rng, (3, 40, 256)), _pm1(rng, (3, 300, 256))
    t[:, :20] = q[:, :20]            # planted matches, another set each
    qv = torch.from_numpy(rng.random((3, 40)) > 0.1)
    tv = torch.from_numpy(rng.random((3, 300)) > 0.2)
    (lm, dist, ok), cfg = _vmapped_match(real, q, qv, t, tv)
    assert calls == [("K2", (3, 40, 256), (3, 300, 256), (3, 300)),
                     ("merge", (3, 3, 40), (3, 40))]
    for b in range(3):
        want = tmatch.match_descriptors_plain(q[b], qv[b], t[b], tv[b], cfg)
        assert int(want.valid.sum()) >= 10
        assert torch.equal(ok[b], want.valid)
        assert torch.equal(lm[b], want.lm_slot)
        assert torch.equal(dist[b], want.distance)


def test_multiseq_runner_from_a_seed_matches_jax():
    """`MultiSequenceRunner(seed=5)` at B = 3 with no sampler takes JAX's
    keys: five frames in chunks of 2 (two chunks, then a frame on its
    own, as both runners' `run` does) give the JAX runner's poses within
    1e-4 and its map counters, and both runners end on the same key."""
    n, batch, chunk, seed = 5, 3, 2, 5
    cfg = tiny_test_config()
    seqs = []
    for b in range(batch):
        gen = PlaneSceneGenerator(cfg.camera, seed=40 + b, texture_ppm=100.0,
                                  texture_size=2048)
        sign = 1.0 if b % 2 == 0 else -1.0
        seqs.append(list(gen.sequence(gen.trajectory(
            n, step_t=(sign * (0.004 + 0.002 * b), 0.002, 0.0),
            step_rot=(0.0, 0.001 * sign, 0.0)))))
    runner = MultiSequenceRunner(cfg, batch=batch, chunk=chunk, seed=seed,
                                 device="cpu")
    runner.run(seqs)

    # JAX's runner on the port's grays (the JAX runner's own luma is a
    # numpy product, which may round otherwise)
    grays = np.stack([np.stack([rgb_to_luma(torch.from_numpy(s[i][0]))
                                .numpy() for s in seqs]) for i in range(n)])
    depths = np.stack([np.stack([s[i][1] for s in seqs]) for i in range(n)])
    times = np.array([[s[i][2] for s in seqs] for i in range(n)],
                     np.float32)
    jrunner = JaxMultiSequenceRunner(
        jax_tiny_config(), batch=batch, seed=seed, chunk=chunk,
        mesh=jmesh.make_mesh(seq=1, obs=1, devices=jax.devices()[:1]))
    for lo in (0, 2):
        jrunner.process_chunk(grays[lo:lo + chunk], depths[lo:lo + chunk],
                              times[lo:lo + chunk])
    jrunner.process_batch(grays[4], depths[4], times[4])

    np.testing.assert_array_equal(runner._key, np.asarray(jrunner._key))
    assert all(all(ok) for ok in runner.tracking_ok)
    for b in range(batch):
        assert len(runner.trajectories[b]) == len(jrunner.trajectories[b]) \
            == n
        for (t0, p), (t1, jp) in zip(runner.trajectories[b],
                                     jrunner.trajectories[b]):
            assert t0 == t1
            np.testing.assert_allclose(p.t.numpy(), np.asarray(jp.t),
                                       rtol=0, atol=POSE_TOL)
            np.testing.assert_allclose(p.q.numpy(), np.asarray(jp.q),
                                       rtol=0, atol=POSE_TOL)
    for k, v in _cat(runner.arenas).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jrunner.arenas,
                                                            k)), err_msg=k)
