"""Distributed Schur-complement bundle adjustment over the ranks of a
process group (counterpart of modular_slam_tpu/parallel/sharded_ba.py).

The observation edge list is split across the mesh's "obs" axis; every
rank holds the (small, replicated) keyframe/landmark state and its block
of observation rows.  Each LM linearization and each CG matvec does its
segment sums locally and all-reduces the [K,6,6]/[L,3]-shaped partials
over the axis's process group: the same `ba_core` as on one device, with
`allreduce` a sum across the ranks (backend/ba.py).

Communication per CG iteration: 2 all-reduces of ~[L,3] + [K,6] floats;
per LM iteration additionally the U/V/b all-reduces.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from modular_slam_tpu_torch.backend.ba import ba_core
from modular_slam_tpu_torch.backend.residuals import ObsData
from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import (backproject,
                                                    camera_from_config)
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.parallel.mesh import Mesh, Spec, local_rows


def make_sharded_global_ba(cfg: SlamConfig, mesh: Mesh,
                           axis: str = "obs") -> Callable:
    """Global BA with the observation list sharded over `axis`.

    Returns fn(arena) -> (arena, BAStats), the arena replicated on every
    rank (on this rank's device) and updated in place.  The observation
    capacity must divide by the axis size (MapConfig defaults are powers
    of two).  Follows the arena's float dtype, as `ba_core` does."""
    cam = camera_from_config(cfg.camera, mesh.device)
    bcfg = cfg.backend
    group = mesh.group(axis)
    shd = Spec((axis,))

    def allreduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x

    def global_ba(arena: MapArena):
        def rows(x):
            return local_rows(mesh, x, shd)

        uv = rows(arena.obs_uv)
        obs = ObsData(kf=rows(arena.obs_kf).long(),
                      lm=rows(arena.obs_lm).long(),
                      p_obs=backproject(cam, uv, rows(arena.obs_depth)),
                      uv=uv, w=rows(arena.obs_valid).to(torch.float32))
        slot0 = torch.arange(arena.max_keyframes,
                             device=arena.kf_q.device) == 0
        q, t, lm, stats = ba_core(
            cam, arena.kf_q, arena.kf_t, arena.lm_pos, obs,
            arena.kf_valid & ~slot0, arena.lm_valid, bcfg,
            residual_type=bcfg.global_residual, allreduce=allreduce)
        arena.kf_q.copy_(q)
        arena.kf_t.copy_(t)
        arena.lm_pos.copy_(lm)
        return arena, stats

    return global_ba
