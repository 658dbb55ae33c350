"""Local-BA scheduler (counterpart of modular_slam_tpu/backend/executor.py).

Local BA is three pure stages (backend/ba.py): extract the window on the
tracking device, solve it, merge it back.  "sync" runs all three inline.
"async" moves the middle one off the tracking device:

  1. extract_window — on the tracking device;
  2. solve_window   — on an offload device (the CPU by default), on a
                      one-worker thread pool; PyTorch's CPU ops release
                      the interpreter lock, so the solve overlaps the next
                      frames' dispatches to the card;
  3. merge_window   — on the tracking device at the next harvest point
                      (the next keyframe, or `flush`).

Merge correctness: arena slots are append-only, and the solve only
rewrites values of the window's slots (poses, landmark positions) and
invalidates outlier observations, so the merge stays exact after new
keyframes and landmarks were appended while the solve was in flight.
The tracked pose receives the window's newest-keyframe correction
(ba.merge_window).  No stale window may be merged after a pose-graph
correction; `drop_pending` abandons one instead.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Tuple

import torch

from modular_slam_tpu_torch.backend.ba import (WindowProblem, extract_window,
                                               local_ba_config, merge_window,
                                               solve_window)
from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import _resolve_device
from modular_slam_tpu_torch.frontend.tracker import TrackState
from modular_slam_tpu_torch.geometry.camera import camera_from_config
from modular_slam_tpu_torch.map.arena import MapArena


def _to(tree, device):
    """Copy every tensor of a (nested) NamedTuple to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        return type(tree)(*(_to(x, device) for x in tree))
    return tree


class BackendExecutor:
    """Local-BA scheduler with "sync" (inline, deterministic) and "async"
    (offloaded solve, merge at the next harvest) modes.

    `device` (default "cuda"; RuntimeError without a CUDA device) is where
    the arena lives; `offload` is where an async solve runs."""

    def __init__(self, cfg: SlamConfig, mode: str = "sync",
                 offload: str = "cpu", device="cuda"):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown BA mode: {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.device = _resolve_device(device)
        self._bcfg = local_ba_config(cfg)
        self._cam = camera_from_config(cfg.camera, self.device)
        self._pending: Optional[Tuple[WindowProblem, Future]] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        if mode == "async":
            self._offload = torch.device(offload)
            self._offload_cam = camera_from_config(cfg.camera, self._offload)
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="local-ba")
        # telemetry
        self.n_submitted = 0
        self.n_merged = 0
        self.n_dropped = 0

    def _extract(self, arena: MapArena, kf_slot) -> WindowProblem:
        return extract_window(self._cam, arena, kf_slot, self._bcfg)

    def submit(self, arena: MapArena, state: TrackState,
               kf_slot: int) -> Tuple[MapArena, TrackState]:
        """A new keyframe landed: schedule its window BA.  Sync mode solves
        inline; async mode merges any pending solve first (windows
        overlap), extracts the new window and hands its solve to the
        worker."""
        self.n_submitted += 1
        if self.mode == "sync":
            prob = self._extract(arena, kf_slot)
            return merge_window(arena, state, prob,
                                solve_window(self._cam, prob, self._bcfg))

        arena, state, _ = self.harvest(arena, state)
        prob = self._extract(arena, kf_slot)
        # the copy waits for the extract on the tracking device's stream
        prob_off = _to(prob, self._offload)
        self._pending = (prob, self._pool.submit(
            solve_window, self._offload_cam, prob_off, self._bcfg))
        return arena, state

    def harvest(self, arena: MapArena,
                state: TrackState) -> Tuple[MapArena, TrackState, bool]:
        """Merge the pending solve into the arena as it is now (blocking
        if it is still in flight)."""
        if self._pending is None:
            return arena, state, False
        prob, fut = self._pending
        self._pending = None
        sol = _to(fut.result(), arena.kf_q.device)
        arena, state = merge_window(arena, state, prob, sol)
        self.n_merged += 1
        return arena, state, True

    def drop_pending(self) -> None:
        """Abandon the in-flight solve (e.g. a pose-graph correction is
        about to move the window's keyframes; merging stale results would
        undo it)."""
        if self._pending is not None:
            _, fut = self._pending
            fut.cancel()
            self._pending = None
            self.n_dropped += 1

    def flush(self, arena: MapArena,
              state: TrackState) -> Tuple[MapArena, TrackState]:
        """Harvest everything (end of a sequence, before reading the map)."""
        arena, state, _ = self.harvest(arena, state)
        return arena, state

    def close(self) -> None:
        self.drop_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
