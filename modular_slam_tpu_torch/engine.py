"""The SLAM engine: per-frame step + host-side system wrapper
(counterpart of modular_slam_tpu/engine.py: the odometry, slam and full
presets, frame by frame).

`make_slam_step` builds the per-frame step — detect, then `track_frame` —
and `SlamSystem.process` drives it with one frame at a time: on a new
keyframe, loop detection (loop/pipeline.py), local BA (backend/) and map
maintenance at the highwater mark (map/lifecycle.py); after tracking
loss, relocalization.  The chunked scan (`make_slam_scan`,
`process_chunk*`, `run(chunk=...)`) has no entry point here yet
(ROADMAP.md, "Next slices").
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
from modular_slam_tpu_torch.map.lifecycle import (compact_arena,
                                                  cull_landmarks,
                                                  evict_keyframes)
from modular_slam_tpu_torch.ops.detector import detect
from modular_slam_tpu_torch.ops.pnp import MultinomialSampler, Sampler
from modular_slam_tpu_torch.types import Features, TrackResult

Tensor = torch.Tensor

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
    """Host-side orchestration: frame feed, trajectory collection, the
    local-BA backend, loop closure, relocalization and map maintenance.

    `device` (default "cuda"; RuntimeError when there is no CUDA device)
    holds the map arena, the tracking state and every per-frame tensor; on
    "cuda" the FAST and Hamming 2-NN kernels run, on "cpu" their plain
    versions.  `sampler(valid, n_hyp) -> [n_hyp, 3]` draws the RANSAC
    triplets: once per tracked frame, and once per candidate of each loop
    verification and relocalization attempt; the default is a
    `MultinomialSampler(seed)`.

    As in the JAX engine, local BA runs every `ba_every` new keyframes
    (`enable_backend`), inline (`ba_mode="sync"`) or solved on the CPU
    and merged at the next keyframe (`"async"`, backend/executor.py);
    `enable_loop_closure` and `enable_relocalization` run the loop
    pipeline (loop/pipeline.py)."""

    def __init__(self, cfg: Optional[SlamConfig] = None, device="cuda",
                 seed: int = 0, enable_backend: bool = True,
                 ba_every: int = 1, enable_loop_closure: bool = False,
                 enable_relocalization: bool = False,
                 ba_mode: str = "sync",
                 sampler: Optional[Sampler] = None):
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
        self.n_compactions = 0
        self.enable_loop_closure = enable_loop_closure
        self.enable_relocalization = enable_relocalization
        self._loop = None
        self.n_loop_closures = 0
        self.n_relocalizations = 0
        if enable_loop_closure or enable_relocalization:
            from modular_slam_tpu_torch.loop.pipeline import LoopPipeline

            self._loop = LoopPipeline(self.cfg, self.device)

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
            kf_slot = int(result.kf_slot)
            if self._loop is not None:
                # merge any in-flight BA before loop detection: a stale
                # window merged after a pose-graph correction would undo it
                self._harvest_ba()
                self.arena, self.state, closed = self._loop.on_new_keyframe(
                    self.arena, self.state, kf_slot, feats, self.sampler,
                    run_loop_detection=self.enable_loop_closure)
                if closed:
                    self.n_loop_closures += 1
            if self.enable_backend:
                self._kf_since_ba += 1
                if self._kf_since_ba >= self.ba_every:
                    self._run_local_ba(kf_slot)
                    self._kf_since_ba = 0
            self._maybe_compact()

        tracking_ok = bool(result.tracking_ok)
        if (not tracking_ok and self.enable_relocalization
                and self._loop is not None):
            new_state, ok = self._loop.relocalize(self.arena, self.state,
                                                  feats, self.sampler)
            if ok:
                self.state = new_state
                self.n_relocalizations += 1
        if tracking_ok:
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
        """Complete all pending work — any in-flight async local BA, any
        queued closure decision and a queued global-BA polish (end of a
        sequence, before reading the map out)."""
        self._harvest_ba()
        self._resolve_pending_closures()
        if self._loop is not None and self._loop._gba_pending:
            kf = self._loop._prev_kf
            if kf is not None:
                self.arena, self.state = self._loop.maybe_run_pending_gba(
                    self.arena, self.state, kf)

    def _resolve_pending_closures(self) -> bool:
        """Decide the loop pipeline's queued verifications, counting the
        closures; -> whether any landed."""
        if self._loop is None or not self._loop.has_pending_closure:
            return False
        self.arena, self.state, closed = self._loop.resolve_pending(
            self.arena, self.state)
        if closed:
            self.n_loop_closures += 1
        return closed

    def _maybe_compact(self) -> bool:
        """Keyframe-rate map maintenance (map/lifecycle.py): when a pool
        crosses its highwater mark, cull weak landmarks, evict keyframes
        down to `kf_evict_target` of the pool and compact the slots, so the
        freed tail keeps accepting insertions.  The tracker's reference
        keyframe and the loop pipeline's slot-aligned structures are
        remapped.  One host read of the three counters per keyframe."""
        m = self.cfg.map
        K, L, O = m.max_keyframes, m.max_landmarks, m.max_observations
        n_kf, n_lm, n_obs = (int(x) for x in torch.stack(
            [self.arena.n_kf, self.arena.n_lm, self.arena.n_obs]).cpu())
        if (n_kf < m.highwater * K and n_lm < m.highwater * L
                and n_obs < m.highwater * O):
            return False
        # compaction moves slots: no in-flight BA window or queued closure
        # decision may survive it
        self._harvest_ba()
        self._resolve_pending_closures()
        arena = cull_landmarks(self.arena, m.cull_min_obs,
                               m.cull_protect_recent)
        arena = evict_keyframes(arena,
                                max_live=max(int(K * m.kf_evict_target), 2))
        self.arena, remaps = compact_arena(arena)
        # remap the tracker's reference keyframe (fallback: the newest)
        ref = int(remaps.kf[int(self.state.ref_kf)])
        if ref >= K:
            ref = max(int(self.arena.n_kf) - 1, 0)
        self.state = self.state._replace(ref_kf=torch.full(
            (), ref, dtype=torch.int32, device=self.device))
        if self._loop is not None:
            self._loop.remap_slots(remaps)
        self.n_compactions += 1
        return True

    # -- introspection ------------------------------------------------------
    def keyframe_trajectory(self) -> np.ndarray:
        """[N, 8] TUM-format rows (t x y z qx qy qz qw) of the valid
        keyframe poses, in slot order.  Unlike `.trajectory` (per-frame
        poses as estimated at the time), this reflects the BA and loop
        corrections applied to the map after the fact."""
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

    def stats(self) -> dict:
        """Map and run statistics (the JAX engine's `stats()`)."""
        last = self.results[-1] if self.results else None
        n_kf, n_lm, n_obs = (int(x) for x in torch.stack(
            [self.arena.n_kf, self.arena.n_lm, self.arena.n_obs]).cpu())
        return {
            "keyframes": n_kf,
            "landmarks": n_lm,
            "observations": n_obs,
            "last_n_matches": int(last.n_matches) if last else 0,
            "last_n_inliers": int(last.n_inliers) if last else 0,
            "tracking_ok": bool(last.tracking_ok) if last else False,
            "loop_closures": self.n_loop_closures,
            "relocalizations": self.n_relocalizations,
            "global_ba_runs":
                self._loop.n_global_ba if self._loop is not None else 0,
            "map_compactions": self.n_compactions,
            "fused_landmarks":
                self._loop.n_fused_landmarks if self._loop is not None else 0,
        }
