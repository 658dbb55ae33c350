"""The SLAM engine: per-frame step + host-side system wrapper
(counterpart of modular_slam_tpu/engine.py: the odometry and slam presets).

`make_slam_step` builds the per-frame step — detect, then `track_frame` —
and `SlamSystem.process` drives it with one frame at a time, running local
BA (backend/) every `ba_every` new keyframes.  The parts of the JAX engine
that later slices port (loop closure, relocalization, map lifecycle) raise
NotImplementedError naming their ROADMAP.md item; none is ignored
silently.  The chunked scan (`process_chunk*`, `run(chunk=...)`) has no
entry point here yet.
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
    """Host-side orchestration: frame feed, trajectory collection and the
    local-BA backend.

    `device` (default "cuda"; RuntimeError when there is no CUDA device)
    holds the map arena, the tracking state and every per-frame tensor; on
    "cuda" the FAST and Hamming 2-NN kernels run, on "cpu" their plain
    versions.  `sampler(valid, n_hyp) -> [n_hyp, 3]` draws the
    RANSAC triplets, once per tracked frame; the default is a
    `MultinomialSampler(seed)`.

    As in the JAX engine, local BA runs every `ba_every` new keyframes
    (`enable_backend`), inline (`ba_mode="sync"`) or solved on the CPU
    and merged at the next keyframe (`"async"`, backend/executor.py)."""

    def __init__(self, cfg: Optional[SlamConfig] = None, device="cuda",
                 seed: int = 0, enable_backend: bool = True,
                 ba_every: int = 1, enable_loop_closure: bool = False,
                 enable_relocalization: bool = False,
                 ba_mode: str = "sync",
                 sampler: Optional[Sampler] = None):
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
        self.enable_backend = enable_backend
        self.ba_every = ba_every
        self.ba_mode = ba_mode  # "sync" (inline) | "async" (offloaded)
        self._kf_since_ba = 0
        self._backend = None  # BackendExecutor, built on first use

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
            if self.enable_backend:
                self._kf_since_ba += 1
                if self._kf_since_ba >= self.ba_every:
                    self._run_local_ba(int(result.kf_slot))
                    self._kf_since_ba = 0
            self._maybe_compact()
        if bool(result.tracking_ok):
            return SlamResult.SUCCESS
        return SlamResult.NO_CONSTRAINTS

    def _ensure_backend(self):
        if self._backend is None:
            from modular_slam_tpu_torch.backend.executor import (
                BackendExecutor)

            self._backend = BackendExecutor(self.cfg, mode=self.ba_mode,
                                            device=self.device)
        return self._backend

    def _run_local_ba(self, kf_slot: int) -> None:
        self.arena, self.state = self._ensure_backend().submit(
            self.arena, self.state, kf_slot)

    def _harvest_ba(self) -> None:
        """Merge an in-flight async local-BA solve, if any."""
        if self._backend is not None:
            self.arena, self.state, _ = self._backend.harvest(
                self.arena, self.state)

    def flush_backend(self) -> None:
        """Complete all pending work — here, any in-flight async local BA
        (end of a sequence, before reading the map out)."""
        self._harvest_ba()

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
    def keyframe_trajectory(self) -> np.ndarray:
        """[N, 8] TUM-format rows (t x y z qx qy qz qw) of the valid
        keyframe poses, in slot order.  Unlike `.trajectory` (per-frame
        poses as estimated at the time), this reflects the BA corrections
        applied to the map after the fact."""
        self.flush_backend()
        valid = self.arena.kf_valid.cpu().numpy()
        q = self.arena.kf_q.cpu().numpy()   # wxyz
        t = self.arena.kf_t.cpu().numpy()
        times = self.arena.kf_time.cpu().numpy()
        idx = np.nonzero(valid)[0]
        out = np.zeros((len(idx), 8), np.float64)
        out[:, 0] = times[idx]
        out[:, 1:4] = t[idx]
        out[:, 4:7] = q[idx, 1:4]  # xyz
        out[:, 7] = q[idx, 0]      # w
        return out

    @property
    def n_keyframes(self) -> int:
        return int(self.arena.n_kf)

    @property
    def n_landmarks(self) -> int:
        return int(self.arena.n_lm)
