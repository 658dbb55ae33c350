"""The port's checkpoints (`utils/checkpoint.py`) against the JAX
package's: a checkpoint the JAX engine wrote on the `slam` and `full`
tiny configurations loads into the port with equal arenas, tracking
state, loop database, edges and PRNG key (integer and bool fields exact,
float fields within 1e-6); a JAX checkpoint resumed in the port and a
port checkpoint resumed in JAX's `load_checkpoint` each continue equal to
the other engine, on JAX's stream; a port run saved after 6 frames and
resumed in a fresh system for 4 more is bit-equal on the CPU to 10
frames straight through; a file of the port's with `sampler_state` and
no `key` still loads, keeping the seeded key; capacities are checked and
the saved vocabulary restored."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from modular_slam_tpu.config import MapConfig, tiny_test_config
from modular_slam_tpu.engine import SlamSystem as JaxSlamSystem
from modular_slam_tpu.utils.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from modular_slam_tpu.utils.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from modular_slam_tpu_torch.loop.vocab import make_vocab
from modular_slam_tpu_torch.models import make_pipeline
from modular_slam_tpu_torch.utils import state as port_state
from modular_slam_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
from modular_slam_tpu_torch.utils.prng import prng_key
from tests.test_torch_engine import _assert_same_frame, _plane_frames

FLOAT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread (see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_equal_fields(label, port: dict, want: dict, tol=FLOAT_TOL):
    for f, w in want.items():
        w = np.asarray(w)
        got = port[f]
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert got.shape == w.shape, (label, f)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got, w, rtol=0, atol=tol,
                                       err_msg=f"{label}.{f}")
        else:
            np.testing.assert_array_equal(got, w, err_msg=f"{label}.{f}")


def _jax_full(monkeypatch, cfg):
    """A JAX full engine with no background global-BA compile."""
    from modular_slam_tpu.loop.pipeline import LoopPipeline as JLoop

    monkeypatch.setattr(JLoop, "_compile_tier_async",
                        lambda self, tier, arena: None)
    monkeypatch.setattr(JLoop, "start_background_prewarm",
                        lambda self, arena: None)
    return JaxSlamSystem(cfg, enable_backend=True, enable_loop_closure=True,
                         enable_relocalization=True)


@pytest.mark.parametrize("preset", ["slam", "full"])
def test_jax_checkpoint_loads_into_the_port(preset, tmp_path, monkeypatch):
    cfg = tiny_test_config()
    jsys = (_jax_full(monkeypatch, cfg) if preset == "full"
            else JaxSlamSystem(cfg, enable_backend=True))
    for f in _plane_frames(cfg, n=5):
        jsys.process(*f)
    assert jsys.params.set("lba_max_num_iterations", 7)
    path = str(tmp_path / "jax.npz")
    jax_save_checkpoint(path, jsys)

    tsys = make_pipeline(preset, cfg, device="cpu")
    load_checkpoint(path, tsys)
    _assert_equal_fields("arena", port_state.arena_to_numpy(tsys.arena),
                         jax.tree.map(np.asarray, jsys.arena)._asdict())
    st = port_state.track_state_to_numpy(tsys.state)
    jst = jax.tree.map(np.asarray, jsys.state)
    _assert_equal_fields("state.pose", st.pop("pose"), jst.pose._asdict())
    _assert_equal_fields("state", st, {k: v for k, v in jst._asdict().items()
                                       if k != "pose"})
    assert tsys.n_keyframes == jsys.n_keyframes > 1
    assert tsys._has_map is None          # read again at the next frame
    assert tsys.cfg.backend.max_iterations == 7
    assert [t for t, _ in tsys.trajectory] == [t for t, _ in jsys.trajectory]
    for (_, p), (_, jp) in zip(tsys.trajectory, jsys.trajectory):
        np.testing.assert_allclose(p.t.numpy(), np.asarray(jp.t), rtol=0,
                                   atol=FLOAT_TOL)
    if preset == "full":
        jlp, tlp = jsys._loop, tsys._loop
        _assert_equal_fields("loopdb",
                             port_state.loop_database_to_numpy(tlp.db),
                             jax.tree.map(np.asarray, jlp.db)._asdict())
        _assert_equal_fields("edges",
                             port_state.pose_graph_edges_to_numpy(tlp.edges),
                             jax.tree.map(np.asarray, jlp.edges)._asdict())
        assert (tlp._n_edges, tlp._prev_kf, tlp._kf_counter,
                tlp._last_closure_at) == (jlp._n_edges, jlp._prev_kf,
                                          jlp._kf_counter,
                                          jlp._last_closure_at)
        assert tlp._n_edges > 0 and bool(tlp.db.valid.any())
    # the JAX file's key is the port's now
    assert tsys._key.dtype == np.uint32
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))
    # and the port tracks on from the loaded map
    for f in _plane_frames(cfg, n=7)[5:]:
        tsys.process(*f)
    assert all(bool(r.tracking_ok) for r in tsys.results)


@pytest.mark.parametrize("preset", ["slam", "full"])
def test_resume_is_bit_equal_to_a_straight_run(preset, tmp_path):
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=10)
    straight = make_pipeline(preset, cfg, device="cpu", seed=3)
    for f in frames:
        straight.process(*f)

    first = make_pipeline(preset, cfg, device="cpu", seed=3)
    for f in frames[:6]:
        first.process(*f)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, first)
    with np.load(path) as data:
        assert "key" in data and "sampler_state" not in data
        assert data["key"].dtype == np.uint32
    resumed = make_pipeline(preset, cfg, device="cpu", seed=11)
    load_checkpoint(path, resumed)
    for f in frames[6:]:
        resumed.process(*f)

    assert resumed.n_keyframes == straight.n_keyframes > 2
    for k, v in port_state.arena_to_numpy(straight.arena).items():
        np.testing.assert_array_equal(
            port_state.arena_to_numpy(resumed.arena)[k], v, err_msg=k)
    for (t0, p0), (t1, p1) in zip(straight.trajectory, resumed.trajectory):
        assert t0 == t1
        assert torch.equal(p0.q, p1.q) and torch.equal(p0.t, p1.t)
    assert len(resumed.trajectory) == len(frames)
    np.testing.assert_array_equal(straight._key, resumed._key)
    if preset == "full":
        for conv, attr in ((port_state.loop_database_to_numpy, "db"),
                           (port_state.pose_graph_edges_to_numpy, "edges")):
            want = conv(getattr(straight._loop, attr))
            got = conv(getattr(resumed._loop, attr))
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_checkpoint_resumes_on_jax_s_stream_in_the_other_engine(
        writer, tmp_path):
    """The slam preset from seed 4: one engine runs 5 frames and saves,
    the other loads the file into a system of another seed, and both
    process 4 more frames: equal codes, flags, counts and poses within
    1e-4, and the same key at the end."""
    cfg = tiny_test_config()
    frames = _plane_frames(cfg, n=9)
    jsys = JaxSlamSystem(cfg, seed=4 if writer == "jax" else 9)
    tsys = make_pipeline("slam", cfg, device="cpu",
                         seed=4 if writer == "port" else 9)
    first, second = (jsys, tsys) if writer == "jax" else (tsys, jsys)
    for f in frames[:5]:
        first.process(*f)
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        jax_save_checkpoint(path, jsys)
        load_checkpoint(path, tsys)
    else:
        save_checkpoint(path, tsys)
        jax_load_checkpoint(path, jsys)
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))
    for k, f in enumerate(frames[5:], start=5):
        _assert_same_frame(k, jsys, jsys.process(*f), tsys, tsys.process(*f))
    np.testing.assert_array_equal(tsys._key, np.asarray(jsys._key))
    assert tsys.n_keyframes == jsys.n_keyframes > 2


def test_a_file_with_sampler_state_and_no_key_still_loads(tmp_path):
    """The port's files before it carried JAX's key held `sampler_state`
    (a CPU generator's state) and no `key`: such a file loads, and the
    system keeps the key of its own seed."""
    cfg = tiny_test_config()
    saved = make_pipeline("slam", cfg, device="cpu", seed=3)
    for f in _plane_frames(cfg, n=4):
        saved.process(*f)
    path = str(tmp_path / "new.npz")
    save_checkpoint(path, saved)
    with np.load(path) as data:
        old = {k: data[k] for k in data.files if k != "key"}
    old["sampler_state"] = torch.Generator().manual_seed(3).get_state(
    ).numpy()
    old_path = str(tmp_path / "old.npz")
    np.savez_compressed(old_path, **old)
    loaded = make_pipeline("slam", cfg, device="cpu", seed=8)
    load_checkpoint(old_path, loaded)
    np.testing.assert_array_equal(loaded._key, prng_key(8))
    for k, v in port_state.arena_to_numpy(saved.arena).items():
        np.testing.assert_array_equal(
            port_state.arena_to_numpy(loaded.arena)[k], v, err_msg=k)
    loaded.process(*_plane_frames(cfg, n=5)[4])
    assert bool(loaded.results[-1].tracking_ok)


def test_capacity_mismatch_raises(tmp_path):
    cfg = tiny_test_config()
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, make_pipeline("odometry", cfg, device="cpu"))
    small = dataclasses.replace(cfg, map=MapConfig(
        max_keyframes=8, max_landmarks=64, max_observations=128))
    with pytest.raises(ValueError, match="capacity mismatch"):
        load_checkpoint(path, make_pipeline("odometry", small, device="cpu"))


def test_saved_vocabulary_is_restored(tmp_path):
    cfg = tiny_test_config()
    saved = make_pipeline("full", cfg, device="cpu")
    path = str(tmp_path / "v.npz")
    save_checkpoint(path, saved)
    other = make_pipeline("full", cfg, device="cpu")
    other._loop.set_vocab(make_vocab(cfg.loop.vocab_size, seed=123))
    assert not torch.equal(other._loop._vocab, saved._loop._vocab)
    load_checkpoint(path, other)
    assert torch.equal(other._loop._vocab, saved._loop._vocab)
