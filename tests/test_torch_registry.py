"""The port's component registry, components, builder, runtime parameters,
frame observers and FrameTimer against the JAX package's
(tests/test_models_registry.py, tests/test_utils.py) on the CPU.

The built-in components must compute what the JAX ones compute (matches
exact; the default components give a step bit-equal to the built-in ops),
a registered detector, matcher and pnp must change what `process` and the
chunked scan do, and a live parameter change must rebuild the step the
way the JAX engine's does."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import tiny_test_config
from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
from modular_slam_tpu.ops.match import match_descriptors as jax_match
from modular_slam_tpu.utils import params as jparams
from modular_slam_tpu.utils import registry as jreg
from modular_slam_tpu.utils.profiling import FrameTimer as JaxFrameTimer
from modular_slam_tpu_torch.engine import (SlamResult, make_slam_scan,
                                           make_slam_step)
from modular_slam_tpu_torch.frontend.tracker import initial_state
from modular_slam_tpu_torch.map.arena import empty_arena
from modular_slam_tpu_torch.models import SlamBuilder, make_pipeline
from modular_slam_tpu_torch.models.components import (DEFAULT_NAMES,
                                                      build_components)
from modular_slam_tpu_torch.ops.pnp import MultinomialSampler, PnpResult
from modular_slam_tpu_torch.types import Matches
from modular_slam_tpu_torch.utils import params as tparams
from modular_slam_tpu_torch.utils import registry as reg
from modular_slam_tpu_torch.utils import state as port_state
from modular_slam_tpu_torch.utils.profiling import FrameTimer
from tests.test_torch_engine import _plane_frames

JAX_BUILTINS = {
    "detector": ["orb_grid"],
    "matcher": ["hamming_2nn", "hamming_2nn_pallas", "hamming_2nn_xla"],
    "pnp": ["ransac_3p"],
    "data_provider": ["realsense", "tum_files"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread (see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _odometry(cfg, **kw):
    return make_pipeline("odometry", cfg, device="cpu", **kw)


def test_builtins_are_the_jax_packages():
    for kind, names in JAX_BUILTINS.items():
        assert set(names) <= set(jreg.available(kind)), kind
        assert set(names) <= set(reg.available(kind)), kind
    assert reg.KINDS == jreg.KINDS
    assert DEFAULT_NAMES == {"detector": "orb_grid",
                             "matcher": "hamming_2nn", "pnp": "ransac_3p"}


def test_create_and_errors():
    cfg = tiny_test_config()
    feats = reg.create("detector", "orb_grid", cfg)(
        torch.zeros(120, 160), torch.zeros(120, 160))
    assert feats.keypoints.uv.shape[0] == cfg.detector.max_keypoints
    with pytest.raises(KeyError):
        reg.create("detector", "missing", cfg)
    with pytest.raises(ValueError):
        reg.register("nonsense_kind", "x")
    with pytest.raises(KeyError, match="unknown component kinds"):
        build_components(cfg, {"backend": "x"})
    with pytest.raises(KeyError):
        build_components(cfg, {"matcher": "missing"})


@pytest.mark.parametrize("name", JAX_BUILTINS["matcher"])
def test_matchers_equal_the_jax_matcher(name):
    """Every registered matcher on CPU tensors: the JAX package's matches,
    exactly (integer Hamming distances)."""
    cfg = tiny_test_config()
    rng = np.random.default_rng(4)
    q = rng.choice(np.int8([-1, 1]), size=(96, 256))
    t = np.concatenate([q[:40] * np.where(rng.random((40, 256)) < 0.1, -1,
                                          1).astype(np.int8),
                        rng.choice(np.int8([-1, 1]), size=(160, 256))])
    qv, tv = rng.random(96) < 0.9, rng.random(200) < 0.8
    got = reg.create("matcher", name, cfg)(
        torch.from_numpy(q), torch.from_numpy(qv), torch.from_numpy(t),
        torch.from_numpy(tv))
    want = jax_match(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t),
                     jnp.asarray(tv), cfg.matcher)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    assert v.sum() > 20
    np.testing.assert_array_equal(got.lm_slot.numpy()[v],
                                  np.asarray(want.lm_slot)[v])
    np.testing.assert_array_equal(got.distance.numpy()[v],
                                  np.asarray(want.distance)[v])


def test_plugin_registration_and_entry_points(monkeypatch):
    calls = []

    @reg.register("detector", "test_custom")
    def _factory(cfg):
        calls.append(cfg)
        return "custom-detector"

    assert "test_custom" in reg.available("detector")
    assert reg.create("detector", "test_custom", None) == "custom-detector"

    class EntryPoint:
        def load(self):
            return lambda: reg.register("pnp", "from_plugin")(lambda cfg: 1)

    import importlib.metadata

    seen = []

    def entry_points(group):
        seen.append(group)
        return [EntryPoint()]

    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    assert reg.load_entry_point_plugins() == 1
    assert seen == ["modular_slam_tpu_torch.plugins"]
    assert "from_plugin" in reg.available("pnp")


def test_pipeline_presets():
    cfg = tiny_test_config()
    s = make_pipeline("odometry", cfg, device="cpu")
    assert not s.enable_backend
    s = make_pipeline("slam", cfg, device="cpu")
    assert s.enable_backend and not s.enable_loop_closure
    s = make_pipeline("full", cfg, device="cpu")
    assert s.enable_backend and s.enable_loop_closure \
        and s.enable_relocalization
    with pytest.raises(KeyError):
        make_pipeline("nope")


def test_builder_fluent_and_observers():
    seen = []
    system = (SlamBuilder(tiny_test_config())
              .with_device("cpu")
              .with_pipeline("odometry")
              .with_detector("orb_grid")
              .with_matcher("hamming_2nn_xla")
              .with_pnp("ransac_3p")
              .with_seed(3)
              .on_frame(lambda ts, pose, res: seen.append(ts))
              .build())
    assert system.component_names == {"detector": "orb_grid",
                                       "matcher": "hamming_2nn_xla",
                                       "pnp": "ransac_3p"}
    assert not system.enable_backend
    rgb, depth, _ = _plane_frames(system.cfg, n=1)[0]
    system.process(rgb, depth, 1.5)
    assert seen == [1.5]
    with pytest.raises(KeyError):
        SlamBuilder(tiny_test_config()).with_detector("bogus")


def _bit_equal_systems(a, b):
    for k, v in port_state.arena_to_numpy(a.arena).items():
        np.testing.assert_array_equal(port_state.arena_to_numpy(
            b.arena)[k], v, err_msg=k)
    for (_, p), (_, q) in zip(a.trajectory, b.trajectory):
        assert torch.equal(p.q, q.q) and torch.equal(p.t, q.t)


def test_default_components_are_the_builtin_step():
    """The registry's default components give the built-in ops' step, bit
    for bit, frame by frame and through the scan."""
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=6)
    dflt = _odometry(cfg, seed=1, component_names=dict(DEFAULT_NAMES))
    builtin = _odometry(cfg, seed=1)
    builtin._step = make_slam_step(cfg, device="cpu")  # components=None
    for f in frames:
        dflt.process(*f)
        builtin.process(*f)
    _bit_equal_systems(dflt, builtin)

    grays = torch.stack([torch.from_numpy(
        f[0].astype(np.float32) @ np.float32([0.299, 0.587, 0.114]))
        for f in frames])
    depths = torch.stack([torch.from_numpy(f[1]) for f in frames])
    times = torch.tensor([f[2] for f in frames], dtype=torch.float32)
    outs = []
    for comps in (None, build_components(cfg)):
        scan = make_slam_scan(cfg, comps, device="cpu")
        outs.append(scan(empty_arena(cfg.map), initial_state(), grays,
                         depths, times, MultinomialSampler(2),
                         bootstrap=True))
    for a, b in zip(port_state.arena_to_numpy(outs[0][0]).values(),
                    port_state.arena_to_numpy(outs[1][0]).values()):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(outs[0][2].pose.t, outs[1][2].pose.t)


def _capped_detector():
    from modular_slam_tpu_torch.ops.detector import detect

    @reg.register("detector", "capped16")
    def _capped(cfg):
        def detect16(gray, depth):
            feats = detect(gray, depth, cfg.detector)
            keep = torch.arange(feats.keypoints.valid.shape[0]) < 16
            kps = feats.keypoints._replace(valid=feats.keypoints.valid
                                           & keep)
            return feats._replace(keypoints=kps)
        return detect16


T_FIXED = (9.0, -3.0, 7.0)


def _fixed_pnp():
    from modular_slam_tpu_torch.geometry.se3 import Pose

    @reg.register("pnp", "fixed_pose")
    def _fixed(cfg):
        def pnp(pts_world, uv, pts_cam, valid, init_pose, sampler):
            pose = Pose(q=torch.tensor([1.0, 0, 0, 0]),
                        t=torch.tensor(T_FIXED))
            return PnpResult(pose=pose, inliers=valid,
                             n_inliers=valid.sum(dtype=torch.int32),
                             ok=torch.tensor(True))
        return pnp


def _reject_all():
    @reg.register("matcher", "reject_all")
    def _reject(cfg):
        def match(q, qv, t, tv):
            n = q.shape[0]
            return Matches(lm_slot=torch.zeros(n, dtype=torch.int32),
                           distance=torch.full((n,), 256.0),
                           valid=torch.zeros(n, dtype=torch.bool))
        return match


@pytest.mark.parametrize("chunk", [1, 3])
def test_custom_components_compose_into_the_engine(chunk):
    """A registered detector, matcher and pnp change what `process`
    (chunk 1) and the chunked scan (chunk 3) compute, as in the JAX
    package's tests/test_models_registry.py."""
    _capped_detector()
    _fixed_pnp()
    _reject_all()
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=3)

    def run(**names):
        system = _odometry(cfg, component_names=names)
        system.run(iter(frames), chunk=chunk)
        return system

    default, capped = run(), run(detector="capped16")
    # the bootstrap frame makes a landmark of every valid keypoint
    assert int(capped.results[0].n_matches) <= 16 \
        < int(default.results[0].n_matches)
    fixed = run(pnp="fixed_pose")
    np.testing.assert_allclose(fixed.trajectory[1][1].t.numpy(), T_FIXED)
    lost = run(matcher="reject_all")
    assert [bool(r.tracking_ok) for r in lost.results] == [True, False,
                                                             False]


def test_parameter_registry_matches_jax():
    """The same calls on the port's and the JAX package's registries give
    the same answers."""
    for mod in (tparams, jparams):
        r = mod.ParameterRegistry()
        new, changed = [], []
        r.subscribe_on_change(lambda k, v, changed=changed:
                              changed.append((k, v)))
        out = [r.register_number("a", 5, 0, 10), r.register_number("a", 1,
                                                                    0, 10),
               r.register_number("b", 50, 0, 10), r.set("a", 7),
               r.set("a", 11), r.set("a", -1), r.get("a"),
               r.register_choice("c", "x", ["x", "y"]), r.set("c", "z"),
               r.set("c", "y"), r.get("c"), r.set("nope", 1), r.has("b"),
               r.names(),
               mod.make_number_parameter("n", 1, 0, 2).type.value,
               mod.make_choice_parameter("m", 1, [1, 2]).type.value]
        r.subscribe_on_new_parameter(lambda p, new=new: new.append(p.key))
        with pytest.raises(KeyError):
            r.get("nope")
        if mod is tparams:
            port = (out, new, changed)
        else:
            assert port == (out, new, changed)


def test_frame_timer_matches_jax():
    summaries = []
    for cls in (FrameTimer, JaxFrameTimer):
        t = cls()
        with t.stage("detect"):
            pass
        t.add("detect", 0.01)
        t.add("track", 0.02)
        summaries.append(t.summary())
    port, want = summaries
    assert port["detect"]["n"] == want["detect"]["n"] == 2
    assert port["track"] == want["track"]
    assert set(port["detect"]) == set(want["detect"])


def test_live_parameters_rebuild_like_jax():
    cfg = tiny_test_config()
    jsys = JaxSlamSystem(cfg, enable_backend=True)
    tsys = make_pipeline("slam", cfg, device="cpu")
    assert tsys.params.names() == jsys.params.names()
    assert {k: tsys.params.get(k) for k in tsys.params.names()} == \
        {k: jsys.params.get(k) for k in jsys.params.names()}
    assert tsys._param_map == jsys._param_map
    for f in _plane_frames(cfg, n=2):
        tsys.process(*f)
    assert tsys._backend is not None
    tsys.process_chunk(*zip(*_plane_frames(cfg, n=4)[2:]))
    assert tsys._scan is not None
    step, comps = tsys._step, tsys.components
    for s in (tsys, jsys):
        assert s.params.set("min_matched_points", 25)
        assert s.cfg.tracker.min_matched_points == 25
        assert not s.params.set("min_matched_points", -1)
        assert s.params.set("lba_max_num_iterations", 7)
        assert s.cfg.backend.max_iterations == 7
        assert s._scan is None and s._backend is None
    assert tsys._step is not step and tsys.components is not comps
    assert tsys.component_names == jsys.component_names
    # the rebuilt step runs, and the backend comes back with the new config
    for f in _plane_frames(cfg, n=6)[4:]:
        assert tsys.process(*f) == SlamResult.SUCCESS
    assert tsys._backend is not None


def test_observers_hear_deferred_chunks_one_chunk_late():
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=6)
    system = _odometry(cfg, defer_chunk_sync=True)
    heard = []
    system.register_frame_observer(lambda ts, pose, res: heard.append(
        (ts, bool(res.tracking_ok))))
    system.process_chunk(*zip(*frames[:3]))
    assert heard == []                        # chunk 0 is still pending
    system.process_chunk(*zip(*frames[3:]))
    assert [t for t, _ in heard] == [f[2] for f in frames[:3]]
    system.flush_backend()
    assert heard == [(f[2], True) for f in frames]
