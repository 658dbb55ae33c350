"""The port from a seed, with no sampler, against the JAX package from the
same seed on the CPU: the odometry and slam presets through `process`,
and the odometry preset through `run(chunk=4)`.

No draw is replayed.  The port threads `PRNGKey(seed)` as the JAX engine
does (utils/prng.py) and draws from each key what `jax.random.choice`
draws from it, so the two engines take the same decisions.  Checked:
every draw of the port is made from the key JAX draws from at the same
place (the JAX engine's keys are recorded as tests/test_torch_engine.py
records them; each chunk's keys as its scan gets them), result codes,
flags, match and inlier counts and keyframe slots are equal, poses agree
within 1e-4, and both systems end on the same key.
"""

import numpy as np
import jax
import pytest
import torch

from modular_slam_tpu.config import tiny_test_config
from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
from modular_slam_tpu_torch.engine import SlamSystem
from modular_slam_tpu_torch.models import make_pipeline
from modular_slam_tpu_torch.utils import prng
from tests.test_torch_chunked import _assert_same_results
from tests.test_torch_engine import (_assert_same_frame,
                                     _assert_same_keyframes, _plane_frames)

SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread (see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_draw_keys(monkeypatch) -> list:
    """The keys of the port's draws, one [2] per draw, as it makes their
    uniforms (`prng.uniform`)."""
    seen = []
    real = prng.uniform

    def uniform(key, shape):
        seen.extend(np.asarray(key).reshape(-1, 2))
        return real(key, shape)

    monkeypatch.setattr(prng, "uniform", uniform)
    return seen


def jax_draw_keys(jsys) -> list:
    """Wrap the JAX engine's step, verification and relocalizer so that
    the keys of their draws land in the returned list in the order the
    port draws them on the `process` path: the tracker's frame key (not
    on the bootstrap frame), a verification's `split(key, top_k)`, a
    relocalization's scan of splits."""
    seen = []
    step = jsys._step

    def step_rec(arena, state, gray, depth, t, key):
        if int(arena.n_kf) > 0:
            seen.append(key)
        return step(arena, state, gray, depth, t, key)

    jsys._step = step_rec
    lp = jsys._loop
    if lp is not None:
        verify, reloc = lp._verify_slots, lp._reloc
        top_k = jsys.cfg.loop.top_k

        def verify_rec(arena, scores, slots, feats, key):
            seen.extend(jax.random.split(key, slots.shape[0]))
            return verify(arena, scores, slots, feats, key)

        def reloc_rec(arena, db, feats, key):
            k = key
            for _ in range(top_k):
                k, sub = jax.random.split(k)
                seen.append(sub)
            return reloc(arena, db, feats, key)

        lp._verify_slots, lp._reloc = verify_rec, reloc_rec
    return seen


def assert_same_draw_keys(port_keys, jax_keys):
    assert len(port_keys) == len(jax_keys) > 0
    np.testing.assert_array_equal(np.stack(port_keys),
                                  np.stack([np.asarray(k) for k in jax_keys]))


@pytest.mark.parametrize("preset", ["odometry", "slam"])
def test_process_from_a_seed_matches_jax(monkeypatch, preset):
    cfg = tiny_test_config()
    jsys = JaxSlamSystem(cfg, seed=SEED, enable_backend=preset == "slam")
    jax_keys = jax_draw_keys(jsys)
    port_keys = port_draw_keys(monkeypatch)
    tsys = make_pipeline(preset, cfg, device="cpu", seed=SEED)
    assert tsys.sampler is None
    for k, f in enumerate(_plane_frames(cfg)):
        _assert_same_frame(k, jsys, jsys.process(*f), tsys, tsys.process(*f))
    assert_same_draw_keys(port_keys, jax_keys)
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))
    kf = [bool(r.new_keyframe) for r in tsys.results]
    assert any(kf[1:]) and not all(kf[1:])
    if preset == "slam":
        assert tsys._backend.n_submitted == sum(kf)
        _assert_same_keyframes(jsys, tsys)


class _NoQueue:
    keys = ()


def test_run_chunked_from_a_seed_matches_jax(monkeypatch):
    """The odometry preset through `run(chunk=4)` over ten frames: two
    chunks, each scan given the keys JAX's scan gets, then the last two
    frames one by one."""
    from modular_slam_tpu import engine as jax_engine
    from modular_slam_tpu_torch import engine as port_engine

    scan_keys = {"jax": [], "port": []}

    def recording(make, side):
        def make_scan(*a, **kw):
            scan = make(*a, **kw)

            def run(*args, **kwargs):
                scan_keys[side].append(np.asarray(args[-1]))
                return scan(*args, **kwargs)
            return run
        return make_scan

    monkeypatch.setattr(jax_engine, "make_slam_scan",
                        recording(jax_engine.make_slam_scan, "jax"))
    monkeypatch.setattr(port_engine, "make_slam_scan",
                        recording(port_engine.make_slam_scan, "port"))
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=10)
    jsys = JaxSlamSystem(cfg, seed=SEED, enable_backend=False)
    tsys = SlamSystem(cfg, SEED, False, device="cpu")
    jsys.run(iter(frames), chunk=4)
    tsys.run(iter(frames), chunk=4)
    _assert_same_results(jsys, tsys, _NoQueue())
    assert len(scan_keys["port"]) == len(scan_keys["jax"]) == 2
    for got, want in zip(scan_keys["port"], scan_keys["jax"]):
        assert got.shape == (4, 2)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))
