"""The SLAM engine: per-frame step + host-side system wrapper
(counterpart of modular_slam_tpu/engine.py, odometry preset only).

`make_slam_step` builds the per-frame step — detect, then `track_frame` —
and `SlamSystem.process` drives it with one frame at a time.  The parts of
the JAX engine that later slices port (local BA, loop closure,
relocalization, map lifecycle) raise NotImplementedError naming their
ROADMAP.md item; none is ignored silently.  The chunked scan
(`process_chunk*`, `run(chunk=...)`) has no entry point here yet.
"""

from __future__ import annotations

import enum
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.frontend.tracker import (TrackState, initial_state,
                                                     track_frame)
from modular_slam_tpu_torch.geometry.camera import camera_from_config
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.io.tum import frame_to_device
from modular_slam_tpu_torch.map.arena import MapArena, empty_arena
from modular_slam_tpu_torch.ops.detector import detect
from modular_slam_tpu_torch.ops.pnp import MultinomialSampler, Sampler
from modular_slam_tpu_torch.types import Features, TrackResult

Tensor = torch.Tensor

_NOT_PORTED = ("{what} is not ported to PyTorch yet (ROADMAP.md, "
               "'Next slices', item {item}); the JAX package "
               "modular_slam_tpu has it")


class SlamResult(enum.Enum):
    """Engine result codes (same values as the JAX engine's)."""

    SUCCESS = 0
    NO_DATA_AVAILABLE = 1
    NO_CONSTRAINTS = 2
    ERROR = 3


def _resolve_device(device) -> torch.device:
    """The entry points run on the card unless the caller asks for the
    CPU; with no CUDA device they raise instead of carrying on there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} but no CUDA device; pass "
                           f"device='cpu' to run the plain versions")
    return dev


def make_slam_step(cfg: SlamConfig, device="cuda") -> Callable:
    """The per-frame engine step for a static config:
    slam_step(arena, state, gray, depth, time, sampler)
        -> (arena, state, result, features)."""
    cam = camera_from_config(cfg.camera, _resolve_device(device))

    def slam_step(arena: MapArena, state: TrackState, gray: Tensor,
                  depth: Tensor, time: Tensor, sampler: Sampler):
        feats = detect(gray, depth, cfg.detector)
        arena, state, result = track_frame(arena, state, feats, cam, cfg,
                                           time, sampler)
        return arena, state, result, feats

    return slam_step


class SlamSystem:
    """Host-side orchestration of the odometry preset: frame feed and
    trajectory collection.

    `device` (default "cuda"; RuntimeError when there is no CUDA device)
    holds the map arena, the tracking state and every per-frame tensor; on
    "cuda" the FAST and Hamming 2-NN kernels run, on "cpu" their plain
    versions.  `sampler(valid, n_hyp) -> [n_hyp, 3]` draws the
    RANSAC triplets, once per tracked frame; the default is a
    `MultinomialSampler(seed)`.

    Unlike the JAX engine, `enable_backend` defaults to False: local BA is
    not ported yet, and asking for it raises."""

    def __init__(self, cfg: Optional[SlamConfig] = None, device="cuda",
                 seed: int = 0, enable_backend: bool = False,
                 enable_loop_closure: bool = False,
                 enable_relocalization: bool = False,
                 sampler: Optional[Sampler] = None):
        if enable_backend:
            raise NotImplementedError(_NOT_PORTED.format(
                what="Local bundle adjustment (enable_backend)", item=1))
        if enable_loop_closure:
            raise NotImplementedError(_NOT_PORTED.format(
                what="Loop closure (enable_loop_closure)", item=3))
        if enable_relocalization:
            raise NotImplementedError(_NOT_PORTED.format(
                what="Relocalization (enable_relocalization)", item=3))
        self.device = _resolve_device(device)
        self.cfg = cfg or SlamConfig()
        self.cam = camera_from_config(self.cfg.camera, self.device)
        self.arena: MapArena = empty_arena(self.cfg.map, self.device)
        self.state: TrackState = initial_state(self.device)
        self.sampler: Sampler = sampler or MultinomialSampler(seed)
        self._step = make_slam_step(self.cfg, self.device)
        self.trajectory: List[Tuple[float, Pose]] = []
        self.results: List[TrackResult] = []
        self.last_features: Optional[Features] = None

    def process(self, rgb: np.ndarray, depth: np.ndarray,
                timestamp: float) -> SlamResult:
        frame = frame_to_device(rgb, depth, timestamp, self.device)
        self.arena, self.state, result, feats = self._step(
            self.arena, self.state, frame.gray, frame.depth,
            frame.timestamp, self.sampler)
        self.last_features = feats
        self.results.append(result)
        pose = Pose(q=result.pose.q, t=result.pose.t)
        self.trajectory.append((timestamp, pose))

        if bool(result.new_keyframe):
            self._maybe_compact()
        if bool(result.tracking_ok):
            return SlamResult.SUCCESS
        return SlamResult.NO_CONSTRAINTS

    def _maybe_compact(self) -> None:
        """The JAX engine culls, evicts and compacts the map when a pool
        crosses `MapConfig.highwater` (engine.py `_maybe_compact`).  Until
        map/lifecycle.py is ported this raises there instead of letting the
        two engines diverge."""
        m = self.cfg.map
        n_kf, n_lm, n_obs = (int(x) for x in torch.stack(
            [self.arena.n_kf, self.arena.n_lm, self.arena.n_obs]).cpu())
        if (n_kf < m.highwater * m.max_keyframes
                and n_lm < m.highwater * m.max_landmarks
                and n_obs < m.highwater * m.max_observations):
            return
        raise NotImplementedError(_NOT_PORTED.format(
            what=(f"Map compaction at the highwater mark (keyframes {n_kf}, "
                  f"landmarks {n_lm}, observations {n_obs})"), item=3))

    # -- introspection ------------------------------------------------------
    @property
    def n_keyframes(self) -> int:
        return int(self.arena.n_kf)

    @property
    def n_landmarks(self) -> int:
        return int(self.arena.n_lm)
