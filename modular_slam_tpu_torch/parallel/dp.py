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

The batch is split into contiguous groups, one per "seq" row of the grid
(parallel/mesh.py), each on its row's first device, where JAX shards the
batch over the mesh; with no communication between sequences the groups
run one after the other on the host, each queued without a host read.
Arenas and states are lists with one stacked entry per row (`[b]` of
row r's entry is sequence r * B / rows + b), results are concatenated
on the first row's device.

RANSAC draws: `samplers` holds one sampler per sequence, and sequence b
draws exactly what samplers[b] would draw for it alone (JAX splits a key
per sequence).  The samplers are of one class, whose
`draw_batch(samplers, valid [B, N], n_hyp)` draws for the batch at once:
`MultinomialSampler`'s draws the uniforms on the host and maps them to
rows on the device in one batched mapping.

The bootstrap is a host flag, as in the port's engine: the first batched
frame bootstraps every sequence.  Like the JAX step, the arenas are
updated in place (map/arena.py).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence, Tuple

import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import (_stack_results, make_slam_step)
from modular_slam_tpu_torch.frontend.tracker import TrackState, initial_state
from modular_slam_tpu_torch.map.arena import MapArena, empty_arena
from modular_slam_tpu_torch.parallel.mesh import Mesh
from modular_slam_tpu_torch.types import TrackResult

Tensor = torch.Tensor


def tree_map(fn: Callable, *trees):
    """fn over the tensors of NamedTuples (nested), None kept."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, tuple):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def row_groups(mesh: Mesh, batch: int) -> List[Tuple[torch.device, slice]]:
    """(device, slice of the batch) of each "seq" row: contiguous groups
    of batch / rows sequences."""
    rows = mesh.devices.shape[0]
    if batch % rows:
        raise ValueError(f"batch {batch} not divisible by {rows} grid rows")
    n = batch // rows
    return [(torch.device(mesh.devices[r, 0]), slice(r * n, (r + 1) * n))
            for r in range(rows)]


class _Sample(torch.autograd.Function):
    """The RANSAC draw inside the vmapped step.  A sampler takes one
    sequence's mask; under `torch.func.vmap` this function's rule gets
    the batch's masks [B, N] as one tensor and calls `draw` once."""

    generate_vmap_rule = False

    @staticmethod
    def forward(valid, n_hyp, draw):
        return draw(valid[None], n_hyp)[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, valid, n_hyp, draw):
        return draw(valid.movedim(in_dims[0], 0), n_hyp), 0


def _batch_draw(samplers: Sequence) -> Callable:
    """(valid [B, N], n_hyp) -> [B, n_hyp, 3], samplers[b] for row b:
    the samplers' class's `draw_batch`."""
    kind = type(samplers[0])
    if any(type(s) is not kind for s in samplers) \
            or not hasattr(kind, "draw_batch"):
        raise TypeError("samplers of one class with draw_batch expected")
    return functools.partial(kind.draw_batch, samplers)


def make_batch_init(cfg: SlamConfig, mesh: Mesh, batch: int
                    ) -> Tuple[List[MapArena], List[TrackState]]:
    """Empty arenas and initial states of `batch` sequences: per grid
    row, its group stacked on the row's device."""
    arenas, states = [], []
    for dev, sl in row_groups(mesh, batch):
        n = sl.stop - sl.start

        def stack(x, n=n):
            return x.expand(n, *x.shape).clone()

        arenas.append(tree_map(stack, empty_arena(cfg.map, dev)))
        states.append(tree_map(stack, initial_state(dev)))
    return arenas, states


def make_batch_slam_step(cfg: SlamConfig, mesh: Mesh) -> Callable:
    """The batched step:
    step(arenas, states, grays [B,H,W], depths [B,H,W], times [B],
         samplers, bootstrap=False) -> (arenas, states, results [B]).
    Frames are moved to each row's device (a no-op where they are).
    Reads nothing back from the device."""
    steps = {}

    def group(dev, arena, state, gray, depth, time, samplers, bootstrap):
        if dev not in steps:
            steps[dev] = make_slam_step(cfg, dev)
        draw = _batch_draw(samplers)

        def sampler(valid, n_hyp):
            return _Sample.apply(valid, n_hyp, draw)

        def one(arena, state, gray, depth, time):
            arena, state, result, _ = steps[dev](arena, state, gray, depth,
                                                 time, sampler, bootstrap)
            return arena, state, tuple(result)[:-1]   # no `relocalized`

        arena, state, result = torch.func.vmap(one)(arena, state, gray,
                                                    depth, time)
        return arena, state, TrackResult(*result)

    def step(arenas, states, grays, depths, times, samplers,
             bootstrap: bool = False):
        if len(samplers) != times.shape[0]:
            raise ValueError(f"{len(samplers)} samplers for a batch of "
                             f"{times.shape[0]}")
        out_a, out_s, results = [], [], []
        for r, (dev, sl) in enumerate(row_groups(mesh, times.shape[0])):
            a, s, res = group(dev, arenas[r], states[r], grays[sl].to(dev),
                              depths[sl].to(dev), times[sl].to(dev),
                              samplers[sl], bootstrap)
            out_a.append(a)
            out_s.append(s)
            results.append(res)
        first = results[0].tracking_ok.device
        return out_a, out_s, tree_map(
            lambda *xs: torch.cat([x.to(first) for x in xs]), *results)

    return step


def make_batch_slam_scan(cfg: SlamConfig, mesh: Mesh) -> Callable:
    """C frames of B sequences:
    fn(arenas, states, grays [C,B,H,W], depths [C,B,H,W], times [C,B],
       samplers, bootstrap=False) -> (arenas, states, results [C,B]).
    A Python loop of the batched step that reads nothing back, as
    `engine.make_slam_scan` is for one sequence; `bootstrap` says the
    arenas are empty before the chunk's first frame."""
    step = make_batch_slam_step(cfg, mesh)

    def scan(arenas, states, grays, depths, times, samplers,
             bootstrap: bool = False):
        results = []
        for i in range(grays.shape[0]):
            arenas, states, r = step(arenas, states, grays[i], depths[i],
                                     times[i], samplers, bootstrap and i == 0)
            results.append(r)
        return arenas, states, _stack_results(results)

    return scan
