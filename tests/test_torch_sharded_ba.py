"""The port's sharded bundle adjustments (modular_slam_tpu_torch/parallel/
sharded_ba.py, kf_sharded_ba.py, halo_ba.py) in one world of 4 gloo
ranks on the CPU, against the JAX functions at the same grid shape on 4
of the 8 virtual CPU devices and against the port's single-device
`make_global_ba`.

The ranks (tests/_torch_sharded_worker.py) import torch, numpy and the
port only; this process builds the problems with the JAX suite's
`_build_problem` (tests/test_backend_ba.py) and hands them numpy arrays.

Tolerances, those of tests/test_parallel.py: initial cost within 1e-5
relative, poses within 1e-4, landmarks within 1e-3 m, every keyframe
within 2e-3 m of the ground truth; the halo diagnostics, each rank's
block shapes and `halo_comms_table` exactly.
"""

import dataclasses
import socket
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import BackendConfig, SlamConfig
from modular_slam_tpu.map.arena import MapArena as JaxArena
from modular_slam_tpu.parallel import (
    halo_comms_table as jax_comms_table,
    make_halo_sharded_global_ba as jax_halo,
    make_kf_mesh as jax_kf_mesh,
    make_kf_sharded_global_ba as jax_kf,
    make_mesh as jax_mesh,
    make_sharded_global_ba as jax_sharded,
)
from modular_slam_tpu_torch.backend.ba import make_global_ba
from modular_slam_tpu_torch.config import BackendConfig as TBackendConfig
from modular_slam_tpu_torch.config import CameraConfig as TCameraConfig
from modular_slam_tpu_torch.config import SlamConfig as TSlamConfig
from modular_slam_tpu_torch.parallel import halo_comms_table
from modular_slam_tpu_torch.utils.state import arena_from_numpy
from tests._torch_sharded_worker import run_rank
from tests.test_backend_ba import CAM_CFG, _build_problem

WORLD = 4
COST_RTOL = 1e-5
POSE_TOL = 1e-4
LM_TOL = 1e-3
GT_TOL_M = 2e-3
TIMEOUT_S = 240

# name -> (problem arguments, kind, grid, halo options)
CASES = {
    "obs": (dict(seed=7), "obs", (1, 4), None),
    "kf": (dict(seed=7), "kf", (2, 2), None),
    "halo": (dict(seed=13), "halo", (4, 1), {}),
    "halo_far": (dict(n_lm=240, seed=14), "halo", (4, 1),
                 {"far_cap": 256}),
}
# the same solves on a float64 arena, against make_global_ba on it
CASES64 = {"obs64": ("obs", (1, 4), None), "kf64": ("kf", (2, 2), None),
           "halo64": ("halo", (4, 1), {})}
F64_FIELDS = ("kf_q", "kf_t", "lm_pos", "obs_uv", "obs_depth")


def _problem(**kw):
    _, arena, gt_poses, _ = _build_problem(**kw)
    gt_t = np.stack([np.asarray(p.t) for p in gt_poses])
    return {k: np.asarray(v) for k, v in arena._asdict().items()}, gt_t


def _cfgs():
    """The JAX config and the port's, built from the port's own classes
    (the ranks unpickle it: no JAX dataclass may ride along)."""
    jcfg = SlamConfig(camera=CAM_CFG,
                      backend=BackendConfig(max_iterations=10))
    tcfg = TSlamConfig(camera=TCameraConfig(**dataclasses.asdict(CAM_CFG)),
                       backend=TBackendConfig(max_iterations=10))
    return jcfg, tcfg


def _jax_run(kind, grid, halo, jcfg, arrays):
    arena = JaxArena(**{k: jnp.asarray(v) for k, v in arrays.items()})
    devs = jax.devices()[:WORLD]
    if kind == "obs":
        out = jax_sharded(jcfg, jax_mesh(*grid, devices=devs))(arena)
    elif kind == "kf":
        out = jax_kf(jcfg, jax_kf_mesh(*grid, devices=devs))(arena)
    else:
        out = jax_halo(jcfg, jax_kf_mesh(*grid, devices=devs), halo=1,
                       **halo)(arena)
    a, stats = out[0], out[1]
    res = {k: np.asarray(getattr(a, k)) for k in ("kf_q", "kf_t",
                                                   "lm_pos")}
    res["initial_cost"] = float(stats.initial_cost)
    if len(out) == 3:
        res["diag"] = {k: int(v) for k, v in out[2].items()}
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_world(cases):
    """One world of WORLD gloo ranks running every case -> rank -> out."""
    ctx = torch.multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=run_rank, args=(r, WORLD, port, cases,
                                                queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    outs = {}
    try:
        for _ in range(WORLD):
            rank, out = queue.get(timeout=TIMEOUT_S)
            assert not isinstance(out, str), f"rank {rank} failed:\n{out}"
            outs[rank] = out
        for p in procs:
            p.join(timeout=60)
            assert p.exitcode == 0, (p.name, p.exitcode)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return outs


@pytest.fixture(scope="module")
def world():
    jcfg, tcfg = _cfgs()
    problems, cases, refs = {}, {}, {}
    for name, (kw, kind, grid, halo) in CASES.items():
        arrays, gt_t = _problem(**kw)
        problems[name] = gt_t
        cases[name] = {"kind": kind, "grid": grid, "halo": halo,
                       "cfg": tcfg, "arena": arrays}
        refs[name] = {
            "jax": _jax_run(kind, grid, halo, jcfg, arrays),
            "port": make_global_ba(tcfg, device="cpu")(
                arena_from_numpy(types.SimpleNamespace(**arrays)))}
    arrays, gt_t = _problem(seed=7)
    a64 = {k: v.astype(np.float64) if k in F64_FIELDS else v
           for k, v in arrays.items()}
    for name, (kind, grid, halo) in CASES64.items():
        problems[name] = gt_t
        cases[name] = {"kind": kind, "grid": grid, "halo": halo,
                       "cfg": tcfg, "arena": arrays, "dtype": "float64"}
        refs[name] = {"port": make_global_ba(tcfg, device="cpu")(
            arena_from_numpy(types.SimpleNamespace(**a64)))}
    outs = _spawn_world(cases)
    return outs, refs, problems


def _close(got, want, atol, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ba_matches_jax_and_single_device(world, name):
    """Every rank ends with the same gathered arena; it agrees with the
    JAX function at the same grid shape and with the port's
    single-device global BA, and it solves the problem."""
    outs, refs, gt = world
    jref = refs[name]["jax"]
    tarena, tstats = refs[name]["port"]
    first = outs[0][name]
    for rank in range(WORLD):
        got = outs[rank][name]
        for k in ("kf_q", "kf_t", "lm_pos"):
            np.testing.assert_array_equal(got[k], first[k],
                                          err_msg=f"rank {rank}: {k}")
    np.testing.assert_allclose(first["initial_cost"], jref["initial_cost"],
                               rtol=COST_RTOL)
    np.testing.assert_allclose(first["initial_cost"],
                               float(tstats.initial_cost), rtol=COST_RTOL)
    for k, tol in (("kf_q", POSE_TOL), ("kf_t", POSE_TOL),
                   ("lm_pos", LM_TOL)):
        _close(first[k], jref[k], tol, f"{name} vs JAX: {k}")
        _close(first[k], getattr(tarena, k).numpy(), tol,
               f"{name} vs make_global_ba: {k}")
    dt = np.linalg.norm(first["kf_t"][:len(gt[name])] - gt[name], axis=1)
    assert dt.max() < GT_TOL_M, dt


@pytest.mark.parametrize("name", list(CASES64))
def test_sharded_ba_follows_float64_inputs(world, name):
    """On a float64 arena the sharded solves stay in float64 and agree
    with the single-device global BA on it."""
    outs, refs, gt = world
    tarena, tstats = refs[name]["port"]
    got = outs[0][name]
    for k, tol in (("kf_q", POSE_TOL), ("kf_t", POSE_TOL),
                   ("lm_pos", LM_TOL)):
        assert got[k].dtype == np.float64, k
        _close(got[k], getattr(tarena, k).numpy(), tol, f"{name}: {k}")
    np.testing.assert_allclose(got["initial_cost"],
                               float(tstats.initial_cost), rtol=COST_RTOL)
    dt = np.linalg.norm(got["kf_t"][:len(gt[name])] - gt[name], axis=1)
    assert dt.max() < GT_TOL_M, dt


@pytest.mark.parametrize("name", ["halo", "halo_far"])
def test_halo_diagnostics_equal_jax(world, name):
    outs, refs, _ = world
    for rank in range(WORLD):
        assert outs[rank][name]["diag"] == refs[name]["jax"]["diag"], rank
    diag = outs[0][name]["diag"]
    assert diag["n_dropped_obs"] == 0
    if name == "halo_far":
        assert diag["n_far_obs"] > 0, "the case must exercise the far set"


@pytest.mark.parametrize("name,nk", [("kf", 2), ("halo", 4),
                                     ("halo_far", 4)])
def test_state_blocks_are_sharded(world, name, nk):
    """Each rank held K/nk keyframes and L/nk landmark blocks (the JAX
    tests read this from `addressable_shards`)."""
    outs, _, _ = world
    K, L = 16, 256
    for rank in range(WORLD):
        assert outs[rank][name]["blocks"] == {
            "kf_q": (K // nk, 4), "kf_t": (K // nk, 3),
            "lm_pos": (L // nk, 3)}, rank


def test_ranks_import_no_jax(world):
    outs, _, _ = world
    for rank in range(WORLD):
        assert outs[rank]["info"] == {
            "process_id": rank, "num_processes": WORLD, "local_devices": 1,
            "global_devices": WORLD}
        assert outs[rank]["jax_modules"] == [], rank


def test_halo_comms_table_equals_jax():
    for args in ((256, 16384, 131072), (16, 256, 2048)):
        for halo, far_cap in ((1, 1024), (2, 256)):
            assert halo_comms_table(*args, halo=halo, far_cap=far_cap) == \
                jax_comms_table(*args, halo=halo, far_cap=far_cap)


def test_no_process_group_no_collective(monkeypatch):
    """Without a process group the sharded BAs refuse a grid of local
    devices (no collective quietly becomes the identity), and the
    bootstrap with no card and no gloo request raises; with no
    coordinator and one process it has nothing to join."""
    from modular_slam_tpu_torch.parallel import (make_kf_mesh, make_mesh,
                                                 make_kf_sharded_global_ba,
                                                 make_halo_sharded_global_ba,
                                                 make_sharded_global_ba)
    from modular_slam_tpu_torch.parallel.bootstrap import (
        initialize_distributed, process_info)

    _, tcfg = _cfgs()
    cpu = [torch.device("cpu")]
    for make, mesh in ((make_sharded_global_ba, make_mesh(devices=cpu)),
                       (make_kf_sharded_global_ba,
                        make_kf_mesh(devices=cpu)),
                       (make_halo_sharded_global_ba,
                        make_kf_mesh(devices=cpu))):
        with pytest.raises(ValueError, match="process group"):
            make(tcfg, mesh)
    for k in ("SLAM_COORDINATOR", "SLAM_NUM_PROCESSES", "SLAM_PROCESS_ID",
              "SLAM_CPU_GLOO"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert process_info() == {"process_id": 0, "num_processes": 1,
                              "local_devices": 1, "global_devices": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            initialize_distributed(f"127.0.0.1:{_free_port()}", 1, 0)
