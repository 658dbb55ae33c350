"""Worker process of tests/test_torch_multihost.py (the port's
counterpart of tests/_multihost_worker.py).

Launched with SLAM_COORDINATOR / SLAM_NUM_PROCESSES / SLAM_PROCESS_ID
set, each process is one gloo rank on the CPU: the bootstrap
(parallel/bootstrap.py) joins them, the observation-sharded segment sum
+ all-reduce of the distributed Schur-complement BA (backend/ba.py
`allreduce`) runs across the process boundary, and then the halo-sharded
global BA (parallel/halo_ba.py) over the 2-rank grid.  The problem
arrives as an .npz written by the test (argv[1]); the worker imports
torch, numpy and the port only.
"""

import os
import sys
import types

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def main(problem_path: str) -> int:
    from modular_slam_tpu_torch.config import (BackendConfig, CameraConfig,
                                               SlamConfig)
    from modular_slam_tpu_torch.parallel import make_halo_sharded_global_ba
    from modular_slam_tpu_torch.parallel.bootstrap import (
        global_mesh, initialize_distributed, process_info)
    from modular_slam_tpu_torch.parallel.mesh import (local_rows,
                                                      make_kf_mesh,
                                                      obs_sharded_specs,
                                                      replicate)
    from modular_slam_tpu_torch.utils.state import arena_from_numpy

    torch.set_num_threads(1)
    assert initialize_distributed(cpu_gloo=True), "env bootstrap missed"
    info = process_info()
    assert info["num_processes"] == 2, info
    assert info["global_devices"] == 2, info
    mesh = global_mesh(seq=1, obs=2)

    # the BA reduction pattern: obs-sharded segment sum + all-reduce ==
    # the unsharded global segment sum
    O, K = 64, 4
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(O,)).astype(np.float32)
    seg = rng.integers(0, K, size=(O,)).astype(np.int64)
    _, shd = obs_sharded_specs()
    v = local_rows(mesh, torch.from_numpy(vals), shd)
    s = local_rows(mesh, torch.from_numpy(seg), shd)
    out = torch.zeros(K).index_add_(0, s, v)
    dist.all_reduce(out, group=mesh.group("obs"))
    want = np.zeros(K, np.float32)
    np.add.at(want, seg, vals)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5)
    print(f"MH OK rank={info['process_id']}", flush=True)

    # the halo-sharded global BA across the two processes: window slabs
    # by point-to-point sends, far-set all-reduces, over gloo
    with np.load(problem_path) as f:
        arrays = {k: f[k] for k in f.files}
    cam = {k: float(arrays.pop("cam_" + k)) for k in
           ("fx", "fy", "cx", "cy")}
    cam.update(width=int(arrays.pop("cam_width")),
               height=int(arrays.pop("cam_height")))
    cfg = SlamConfig(camera=CameraConfig(**cam),
                     backend=BackendConfig(max_iterations=8))
    kf_mesh = make_kf_mesh(kf=2, obs=1)
    if dist.get_rank() != 0:
        arrays = {k: np.zeros_like(a) for k, a in arrays.items()}
    arena = replicate(kf_mesh, arena_from_numpy(
        types.SimpleNamespace(**arrays)))
    halo = make_halo_sharded_global_ba(cfg, kf_mesh, halo=1, far_cap=128)
    arena, stats, diag, _ = halo(arena)
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    assert np.isfinite(c1) and c1 <= c0 * 0.05, (c0, c1)
    assert int(diag["n_dropped_obs"]) == 0, diag
    print(f"MH HALO OK rank={info['process_id']} "
          f"cost {c0:.3e}->{c1:.3e}", flush=True)
    dist.destroy_process_group()
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "modular_slam_tpu")]
    assert not leaked, leaked
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1]))
