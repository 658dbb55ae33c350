"""Multi-sequence data parallelism: one SLAM instance per sequence of a
batch (counterpart of modular_slam_tpu/parallel/dp.py).

BASELINE config 5's data axis: independent sequences each carry their
own map arena and tracking state, and one batched step tracks a frame of
every sequence.  As in JAX, the batched step is the single-sequence step
(`engine.make_slam_step`: detect, then `track_frame`) under `vmap` —
here `torch.func.vmap` — so that every op runs once for the batch:
kernel K1 launches once per batched frame, and K2 and its merge once per
tracked batched frame (their operators' vmap rules, ops/fast.py and
ops/match.py).  The arena inserts, the tracker and PnP have batching
rules for every op (no per-sequence fallback loop).

The batch is split into contiguous groups, one per index of the grid's
`axis` (parallel/mesh.py; "seq", the rows, by default), each on the first
device of its slice of the grid, where JAX shards the batch over that
mesh axis; with no communication between sequences the groups run one
after the other on the host, each queued without a host read.  Arenas
and states are lists with one stacked entry per group (`[b]` of group
r's entry is sequence r * B / groups + b), results are concatenated on
the first group's device.  An `axis` that is not one of
`mesh.axis_names` raises ValueError, as JAX's `P(axis)` does.

RANSAC draws: as in JAX, sequence b draws from its own key, keys[b] of
the step's [B, 2] (of the scan's [C, B, 2]), what a single-sequence step
draws from that key.  The uniforms of all the keys are made on the host
and go to the device in one upload per call (utils/prng.py), and the
vmapped step maps them to rows against the batch's masks in one batched
mapping.

The span `step` (utils/profiling.py) holds the host's dispatch of one
batched frame over all groups; the stage spans inside it open once per
batched frame, since the vmapped step runs its Python once for the batch.

The bootstrap is a host flag, as in the port's engine: the first batched
frame bootstraps every sequence.  Like the JAX step, the arenas are
updated in place (map/arena.py).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import (_stack_results, make_slam_step)
from modular_slam_tpu_torch.frontend.tracker import TrackState, initial_state
from modular_slam_tpu_torch.map.arena import MapArena, empty_arena
from modular_slam_tpu_torch.parallel.mesh import Mesh
from modular_slam_tpu_torch.types import TrackResult
from modular_slam_tpu_torch.utils.prng import Uniforms, device_uniforms
from modular_slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def tree_map(fn: Callable, *trees):
    """fn over the tensors of NamedTuples (nested), None kept."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, tuple):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _axis_index(mesh: Mesh, axis: str) -> int:
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not one of the mesh's "
                         f"{tuple(mesh.axis_names)}")
    return list(mesh.axis_names).index(axis)


def row_groups(mesh: Mesh, batch: int, axis: str = "seq"
               ) -> List[Tuple[torch.device, slice]]:
    """(device, slice of the batch) of each index along the grid's `axis`:
    contiguous groups of batch / mesh.shape[axis] sequences, each on the
    first device of its slice of the grid."""
    slices = np.moveaxis(mesh.devices, _axis_index(mesh, axis), 0)
    groups = slices.shape[0]
    if batch % groups:
        raise ValueError(f"batch {batch} not divisible by {groups} grid "
                         f"slices along {axis!r}")
    n = batch // groups
    return [(torch.device(slices[g].flat[0]), slice(g * n, (g + 1) * n))
            for g in range(groups)]


def _draws(keys, shape: Tuple[int, ...], n_hyp: int, device) -> Uniforms:
    """The uniforms of keys [*shape, 2], in one upload; `Uniforms` are
    taken as they are."""
    if isinstance(keys, Uniforms):
        return keys
    if np.shape(keys) != (*shape, 2):
        raise ValueError(f"keys of shape {np.shape(keys)}; expected "
                         f"{(*shape, 2)}")
    return device_uniforms(keys, n_hyp, device)


def make_batch_init(cfg: SlamConfig, mesh: Mesh, batch: int,
                    axis: str = "seq"
                    ) -> Tuple[List[MapArena], List[TrackState]]:
    """Empty arenas and initial states of `batch` sequences: per group
    along `axis`, its sequences stacked on the group's device."""
    arenas, states = [], []
    for dev, sl in row_groups(mesh, batch, axis):
        n = sl.stop - sl.start

        def stack(x, n=n):
            return x.expand(n, *x.shape).clone()

        arenas.append(tree_map(stack, empty_arena(cfg.map, dev)))
        states.append(tree_map(stack, initial_state(dev)))
    return arenas, states


def make_batch_slam_step(cfg: SlamConfig, mesh: Mesh,
                         axis: str = "seq") -> Callable:
    """The batched step:
    step(arenas, states, grays [B,H,W], depths [B,H,W], times [B],
         keys [B, 2], bootstrap=False) -> (arenas, states, results [B]),
    the batch split along the grid's `axis`.  Frames are moved to each
    group's device (a no-op where they are).  Reads nothing back from the
    device."""
    _axis_index(mesh, axis)             # an unknown axis raises here
    steps = {}

    def group(dev, arena, state, gray, depth, time, u, bootstrap):
        if dev not in steps:
            steps[dev] = make_slam_step(cfg, device=dev)

        def one(arena, state, gray, depth, time, u):
            arena, state, result, _ = steps[dev](arena, state, gray, depth,
                                                 time, Uniforms(u),
                                                 bootstrap=bootstrap)
            return arena, state, tuple(result)[:-1]   # no `relocalized`

        arena, state, result = torch.func.vmap(one)(arena, state, gray,
                                                    depth, time, u)
        return arena, state, TrackResult(*result)

    def step(arenas, states, grays, depths, times, keys,
             bootstrap: bool = False):
        with span("step"):
            u = _draws(keys, (times.shape[0],), cfg.pnp.n_hypotheses,
                       times.device).u
            out_a, out_s, results = [], [], []
            for r, (dev, sl) in enumerate(row_groups(mesh, times.shape[0],
                                                     axis)):
                a, s, res = group(dev, arenas[r], states[r],
                                  grays[sl].to(dev), depths[sl].to(dev),
                                  times[sl].to(dev), u[sl].to(dev),
                                  bootstrap)
                out_a.append(a)
                out_s.append(s)
                results.append(res)
            first = results[0].tracking_ok.device
            return out_a, out_s, tree_map(
                lambda *xs: torch.cat([x.to(first) for x in xs]), *results)

    return step


def make_batch_slam_scan(cfg: SlamConfig, mesh: Mesh,
                         axis: str = "seq") -> Callable:
    """C frames of B sequences:
    fn(arenas, states, grays [C,B,H,W], depths [C,B,H,W], times [C,B],
       keys [C,B,2], bootstrap=False) -> (arenas, states, results [C,B]).
    A Python loop of the batched step that reads nothing back, as
    `engine.make_slam_scan` is for one sequence, with the uniforms of all
    C x B keys uploaded once before it; `bootstrap` says the arenas are
    empty before the chunk's first frame; the batch splits along `axis`
    as in `make_batch_slam_step`."""
    step = make_batch_slam_step(cfg, mesh, axis)

    def scan(arenas, states, grays, depths, times, keys,
             bootstrap: bool = False):
        draws = _draws(keys, tuple(times.shape), cfg.pnp.n_hypotheses,
                       times.device)
        results = []
        for i in range(grays.shape[0]):
            arenas, states, r = step(arenas, states, grays[i], depths[i],
                                     times[i], draws[i], bootstrap and i == 0)
            results.append(r)
        return arenas, states, _stack_results(results)

    return scan
