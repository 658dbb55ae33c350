"""A rank of the gloo world of tests/test_torch_sharded_ba.py.

Imports torch, numpy and the port only: the test's parent process builds
the problems (numpy arrays) and the JAX references.  Each rank joins the
world through `parallel/bootstrap.initialize_distributed`, builds every
case's grid (every rank creates the same process groups in the same
order), replicates rank 0's arena onto every rank (the others pass
zeros), runs the case's sharded BA and puts its result on `queue`.
"""

import sys
import traceback
import types

import numpy as np
import torch
import torch.distributed as dist


def _result(arena, stats, diag=None, blocks=None) -> dict:
    out = {k: getattr(arena, k).numpy().copy()
           for k in ("kf_q", "kf_t", "lm_pos")}
    out.update(initial_cost=float(stats.initial_cost),
               final_cost=float(stats.final_cost),
               n_active_obs=int(stats.n_active_obs),
               diag=None if diag is None else
               {k: int(v) for k, v in diag.items()},
               blocks=blocks)
    return out


def run_case(case: dict):
    from modular_slam_tpu_torch.parallel import (make_halo_sharded_global_ba,
                                                 make_kf_mesh, make_mesh,
                                                 make_kf_sharded_global_ba,
                                                 make_sharded_global_ba)
    from modular_slam_tpu_torch.parallel.mesh import replicate
    from modular_slam_tpu_torch.utils.state import arena_from_numpy

    kind, cfg = case["kind"], case["cfg"]
    if kind == "obs":
        mesh = make_mesh(*case["grid"])
    else:
        mesh = make_kf_mesh(*case["grid"])
    arrays = case["arena"]
    if dist.get_rank() != 0:
        arrays = {k: np.zeros_like(v) for k, v in arrays.items()}
    arena = replicate(mesh, arena_from_numpy(
        types.SimpleNamespace(**arrays), mesh.device))
    if case.get("dtype") == "float64":
        arena = arena._replace(**{k: getattr(arena, k).double() for k in
                                  ("kf_q", "kf_t", "lm_pos", "obs_uv",
                                   "obs_depth")})
    if kind == "obs":
        return _result(*make_sharded_global_ba(cfg, mesh)(arena))
    if kind == "kf":
        arena, stats, blocks = make_kf_sharded_global_ba(cfg, mesh)(arena)
        return _result(arena, stats, blocks=blocks)
    fn = make_halo_sharded_global_ba(cfg, mesh, halo=1, **case["halo"])
    return _result(*fn(arena))


def run_rank(rank: int, world: int, port: int, cases: dict, queue) -> None:
    from modular_slam_tpu_torch.parallel.bootstrap import (
        initialize_distributed, process_info)

    torch.set_num_threads(1)
    try:
        assert initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                      cpu_gloo=True)
        out = {"info": process_info()}
        for name, case in cases.items():
            out[name] = run_case(case)
        out["jax_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0] in
            ("jax", "jaxlib", "modular_slam_tpu"))
        queue.put((rank, out))
    except Exception:                  # the parent reports the traceback
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
