"""The full preset from a seed, with no sampler, against the JAX package
from the same seed on the CPU: a loop closure, a kidnap relocalized
through `process`, and a kidnap rescued by the in-scan relocalizer of the
chunked path.

As in tests/test_torch_seed.py, no draw is replayed: the port draws from
the keys JAX draws from (checked key by key on the `process` path), and
codes, flags, counts, closures, relocalizations and compactions are
equal, poses within 1e-4, and both systems end on the same key.  The JAX
side gets every global-BA tier up front and no background compile
(tests/test_torch_engine.py `_full_pair`), so no closure defers its
global BA.
"""

import numpy as np
import pytest
import torch

from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
from modular_slam_tpu_torch.engine import SlamSystem
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from tests.test_torch_chunked import _assert_same_results
from tests.test_torch_engine import (POSE_TOL, _CLOSURE_LOOP, _EveryTier,
                                     _assert_same_frame,
                                     _assert_same_keyframes, _full_cfg,
                                     _out_and_back)
from tests.test_torch_seed import (_NoQueue, assert_same_draw_keys,
                                   jax_draw_keys, port_draw_keys)

SEED = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread (see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded_pair(monkeypatch, cfg, **kw):
    from modular_slam_tpu.loop.pipeline import LoopPipeline as JLoop

    monkeypatch.setattr(JLoop, "_compile_tier_async",
                        lambda self, tier, arena: None)
    monkeypatch.setattr(JLoop, "start_background_prewarm",
                        lambda self, arena: None)
    jsys = JaxSlamSystem(cfg, seed=SEED, **kw)
    jsys._loop._gba_tiers = _EveryTier(cfg)
    tsys = SlamSystem(cfg, seed=SEED, device="cpu", **kw)
    return jsys, tsys


def _step(k, jsys, tsys, frame):
    _assert_same_frame(k, jsys, jsys.process(*frame), tsys,
                       tsys.process(*frame))
    for f in ("n_loop_closures", "n_relocalizations", "n_compactions"):
        assert getattr(tsys, f) == getattr(jsys, f), (k, f)


def test_full_preset_from_a_seed_closes_the_loop_like_jax(monkeypatch):
    """The out-and-back closure of tests/test_engine_full.py:67."""
    cfg = _full_cfg(**_CLOSURE_LOOP)
    jsys, tsys = _seeded_pair(monkeypatch, cfg, enable_backend=True,
                              enable_loop_closure=True,
                              enable_relocalization=True)
    jax_keys = jax_draw_keys(jsys)
    port_keys = port_draw_keys(monkeypatch)
    for k, f in enumerate(_out_and_back(cfg)):
        _step(k, jsys, tsys, f)
    assert_same_draw_keys(port_keys, jax_keys)
    assert tsys.n_loop_closures >= 1
    assert [c[:2] for c in tsys._loop.closures] == [
        tuple(int(x) for x in c[:2]) for c in jsys._loop.closures]
    _assert_same_keyframes(jsys, tsys)
    assert tsys._loop.n_global_ba == jsys._loop.n_global_ba >= 2
    assert tsys.stats() == jsys.stats()
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))


def _kidnap_frames(cfg, back: int):
    """tests/test_engine_full.py:95: twelve 0.5 m steps, then the first
    `back` views again."""
    gen = PlaneSceneGenerator(cfg.camera, texture_ppm=250, seed=35)
    poses = gen.trajectory(12, step_t=(0.5, 0.0, 0.0))
    frames = list(gen.sequence(poses))
    return poses, frames + frames[:back]


def test_full_preset_from_a_seed_relocalizes_like_jax(monkeypatch):
    cfg = _full_cfg()
    poses, frames = _kidnap_frames(cfg, 1)
    jsys, tsys = _seeded_pair(monkeypatch, cfg, enable_backend=False,
                              enable_relocalization=True)
    jax_keys = jax_draw_keys(jsys)
    port_keys = port_draw_keys(monkeypatch)
    for k, f in enumerate(frames):
        _step(k, jsys, tsys, f)
    assert_same_draw_keys(port_keys, jax_keys)
    assert tsys.n_relocalizations == jsys.n_relocalizations == 1
    for f in ("q", "t"):
        np.testing.assert_allclose(
            getattr(tsys.state.pose, f).numpy(),
            np.asarray(getattr(jsys.state.pose, f)), rtol=0, atol=POSE_TOL)
    assert float(np.linalg.norm(tsys.state.pose.t.numpy() - poses[0].t)) \
        < 0.05
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))


def test_in_scan_relocalization_from_a_seed_matches_jax(monkeypatch):
    """The kidnap in the second of two chunks of 7 (synchronous): the
    in-scan relocalizer, whose keys are split on every frame of the scan,
    rescues the kidnap frame as JAX's does."""
    from modular_slam_tpu import engine as jax_engine

    relocalized = []
    make = jax_engine.make_slam_scan

    def make_scan(*a, **kw):
        scan = make(*a, **kw)

        def run(*args):
            out = scan(*args)
            relocalized.extend(np.asarray(out[2][0].relocalized).tolist())
            return out
        return run

    monkeypatch.setattr(jax_engine, "make_slam_scan", make_scan)
    cfg = _full_cfg()
    _, frames = _kidnap_frames(cfg, 2)
    jsys, tsys = _seeded_pair(monkeypatch, cfg, enable_backend=False,
                              enable_relocalization=True)
    jsys.run(iter(frames), chunk=7)
    tsys.run(iter(frames), chunk=7)
    _assert_same_results(jsys, tsys, _NoQueue())
    trelocd = [bool(r.relocalized) for r in tsys.results]
    assert trelocd == [bool(x) for x in relocalized]
    assert not tsys.results[12].tracking_ok and trelocd[12]
    assert tsys._loop.n_reloc_attempts >= 1
    np.testing.assert_allclose(tsys.state.pose.t.numpy(),
                               np.asarray(jsys.state.pose.t), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))
