"""The SLAM engine: per-frame step, chunked scan and host-side system
wrapper (counterpart of modular_slam_tpu/engine.py: the odometry, slam and
full presets, frame by frame and chunk by chunk).

`make_slam_step` builds the per-frame step — detect, then `track_frame` —
and `SlamSystem.process` drives it with one frame at a time: on a new
keyframe, loop detection (loop/pipeline.py), local BA (backend/) and map
maintenance at the highwater mark (map/lifecycle.py); after tracking
loss, relocalization.

`make_slam_scan` runs the same step over a chunk of frames with no host
read (the JAX `lax.scan`), and `SlamSystem.process_chunk*` / `run(chunk=...)`
fetch the chunk's results once and run the keyframe-rate work off its
flags; with `defer_chunk_sync=True` the host finishes chunk N while the
device runs chunk N+1.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.frontend.tracker import (TrackState, initial_state,
                                                     track_frame)
from modular_slam_tpu_torch.geometry.camera import camera_from_config
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.io.tum import frame_to_device, rgb_to_luma
from modular_slam_tpu_torch.map.arena import MapArena, empty_arena
from modular_slam_tpu_torch.map.lifecycle import (compact_arena,
                                                  cull_landmarks,
                                                  evict_keyframes)
from modular_slam_tpu_torch.ops.detector import detect
from modular_slam_tpu_torch.ops.pnp import Sampler
from modular_slam_tpu_torch.types import Features, TrackResult
from modular_slam_tpu_torch.utils.device import upload
from modular_slam_tpu_torch.utils.params import ParameterRegistry
from modular_slam_tpu_torch.utils.prng import (device_uniforms, prng_key,
                                               split)
from modular_slam_tpu_torch.utils.profiling import span

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


def _resolve(cfg: SlamConfig, components):
    """(detect_fn, match_fn, pnp_fn) from an injected Components, or the
    built-in ops (models/components.py has the contracts)."""
    if components is not None:
        return components.detect, components.match, components.pnp
    return (lambda gray, depth: detect(gray, depth, cfg.detector),
            None, None)


def make_slam_step(cfg: SlamConfig, components=None, *,
                   device="cuda") -> Callable:
    """The per-frame engine step for a static config:
    slam_step(arena, state, gray, depth, time, key, bootstrap=None)
        -> (arena, state, result, features),
    `key` the frame's PRNG key (utils/prng.py; or a stand-in, ops/pnp.py).
    `bootstrap` says whether the arena is empty (read from it when None);
    given, the step reads nothing back from the device.  `components`
    (models/components.Components) injects the detector, matcher and pnp;
    None uses the built-ins.  The detector runs in the span `step.detect`
    (utils/profiling.py), the tracker's stages in theirs
    (frontend/tracker.py)."""
    cam = camera_from_config(cfg.camera, _resolve_device(device))
    detect_fn, match_fn, pnp_fn = _resolve(cfg, components)

    def slam_step(arena: MapArena, state: TrackState, gray: Tensor,
                  depth: Tensor, time: Tensor, key,
                  bootstrap: Optional[bool] = None):
        with span("step.detect"):
            feats = detect_fn(gray, depth)
        arena, state, result = track_frame(
            arena, state, feats, cam, cfg, time, key,
            match_fn=match_fn, pnp_fn=pnp_fn, bootstrap=bootstrap)
        return arena, state, result, feats

    return slam_step


def _stack_results(results: List[TrackResult]) -> TrackResult:
    """Per-frame TrackResults -> one with a leading chunk axis."""
    def stack(f):
        return torch.stack([getattr(r, f) for r in results])

    return TrackResult(
        pose=Pose(q=torch.stack([r.pose.q for r in results]),
                  t=torch.stack([r.pose.t for r in results])),
        n_matches=stack("n_matches"), n_inliers=stack("n_inliers"),
        tracking_ok=stack("tracking_ok"), new_keyframe=stack("new_keyframe"),
        kf_slot=stack("kf_slot"),
        relocalized=(None if results[0].relocalized is None
                     else stack("relocalized")))


def make_slam_scan(cfg: SlamConfig, components=None, with_features=False,
                   reloc_vocab: Optional[Tensor] = None, *,
                   device="cuda") -> Callable:
    """The chunked step (the JAX `make_slam_scan`), with `components` as
    in `make_slam_step`:
    fn(arena, state, [db,] grays [C,H,W], depths [C,H,W], times [C],
       keys [C, 2], bootstrap=False) -> (arena, state, stacked
    TrackResult), or (arena, state, (stacked TrackResult, [C] per-frame
    Features)) with `with_features`.  `bootstrap` says the arena is empty
    before the chunk's first frame.

    The frames run through the per-frame step in a Python loop that reads
    nothing back from the device: the JAX `lax.scan` becomes a queue of
    kernel launches, fetched once by the caller.  Each frame splits its
    key as the JAX scan does, `k_track, k_reloc = split(key)`: the tracker
    draws from k_track, the relocalizer from k_reloc's chained splits
    (loop/relocalizer.candidate_keys).  All the chunk's uniforms, the
    relocalizer's included, are made on the host before the first frame
    and go to the device in one upload.  A sampler in place of `keys`
    (ops/pnp.py) draws every triplet itself.

    `reloc_vocab` ([V, 256] ±1 int8, the BoW codebook) adds in-scan
    relocalization: the fn takes the keyframe database `db`
    (loop.detector.LoopDatabase) after `state`, and a frame whose tracking
    failed runs the relocalizer (loop/relocalizer.py) against it at once,
    recovering on the next frame.  PyTorch has no device-side branch for
    the JAX `lax.cond`: `tracking_ok` is read once per frame, and only
    lost frames run the relocalizer (a masked attempt on every frame
    would cost a BoW histogram and a 3-candidate verification per
    frame).  `relocalized` flags the frames it rescued."""
    dev = _resolve_device(device)
    cam = camera_from_config(cfg.camera, dev)
    detect_fn, match_fn, pnp_fn = _resolve(cfg, components)
    reloc_fn = None
    top_k = 0
    if reloc_vocab is not None:
        from modular_slam_tpu_torch.loop.relocalizer import (
            candidate_keys, make_relocalizer)

        reloc_fn = make_relocalizer(cfg, reloc_vocab)
        top_k = cfg.loop.top_k

    def frame_draws(keys, C):
        """[(tracker's key, relocalizer's keys)] of the C frames: their
        `Uniforms`, made from keys [C, 2] in one upload."""
        if callable(keys):
            return [(keys, keys)] * C
        if np.shape(keys) != (C, 2):
            raise ValueError(f"keys of shape {np.shape(keys)} for {C} "
                             f"frames; expected ({C}, 2)")
        pairs = split(keys)                     # [C, (k_track, k_reloc), 2]
        per_frame = pairs[:, :1]
        if top_k:
            per_frame = np.concatenate(
                [per_frame, candidate_keys(pairs[:, 1], top_k)], axis=1)
        u = device_uniforms(per_frame, cfg.pnp.n_hypotheses, dev)
        return [(u[i, 0], u[i, 1:]) for i in range(C)]

    def frames(arena, state, db, grays, depths, times, keys, bootstrap):
        results, feats_all = [], []
        no = torch.zeros((), dtype=torch.bool, device=dev)
        draws = frame_draws(keys, grays.shape[0])
        for i in range(grays.shape[0]):
            k_track, k_reloc = draws[i]
            with span("step.detect"):
                feats = detect_fn(grays[i], depths[i])
            arena, state, result = track_frame(
                arena, state, feats, cam, cfg, times[i], k_track,
                bootstrap=bootstrap and i == 0, match_fn=match_fn,
                pnp_fn=pnp_fn)
            if reloc_fn is not None:
                relocd = no
                if not bool(result.tracking_ok):   # the frame's host read
                    ok, pose, slot, _ = reloc_fn(arena, db, feats, k_reloc)
                    state = TrackState(
                        pose=Pose(q=torch.where(ok, pose.q, state.pose.q),
                                  t=torch.where(ok, pose.t, state.pose.t)),
                        ref_kf=torch.where(ok, slot, state.ref_kf).to(
                            torch.int32),
                        frame_idx=state.frame_idx,
                        lost=torch.where(ok, no, state.lost),
                        since_kf=state.since_kf)
                    relocd = ok
                result = result._replace(relocalized=relocd)
            results.append(result)
            feats_all.append(feats)
        out = _stack_results(results)
        return arena, state, ((out, feats_all) if with_features else out)

    if reloc_fn is None:
        def slam_scan(arena, state, grays, depths, times, keys,
                      bootstrap=False):
            return frames(arena, state, None, grays, depths, times, keys,
                          bootstrap)
    else:
        def slam_scan(arena, state, db, grays, depths, times, keys,
                      bootstrap=False):
            return frames(arena, state, db, grays, depths, times, keys,
                          bootstrap)
    return slam_scan


def _should_relocalize(ok: np.ndarray, n_inliers: np.ndarray,
                       min_inliers: int) -> bool:
    """Chunk-boundary relocalization trigger (a copy of the JAX engine's):
    the chunk ENDS lost, or a frame of it was lost and its last frame is
    weak (fewer than `min_inliers` inliers) — a kidnap that squeaked past
    on the last PnP, not a recovery.  A last frame with enough inliers has
    re-found the map, and relocalizing there would rewind it."""
    if not ok[-1]:
        return True
    lost_any = bool((~np.asarray(ok)).any())
    weak_end = int(n_inliers[-1]) < min_inliers
    return lost_any and weak_end


class _HostFetch:
    """A device tensor's copy on its way to the host.  On the card it goes
    into pinned memory with non_blocking=True and an event is recorded
    behind it, so `wait()` waits for this copy only — a `.cpu()` issued
    after the next chunk's launches would wait for all of them too."""

    def __init__(self, x: Tensor):
        self.event = None
        if x.is_cuda:
            self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self.host.copy_(x, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = x

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


# columns of a chunk's packed results: q (4), t (3), then one each
_PACKED = ("tracking_ok", "new_keyframe", "kf_slot", "n_matches",
           "n_inliers", "relocalized")


def _pack_results(results: TrackResult, counters: Optional[Tensor]
                  ) -> Tensor:
    """A chunk's stacked results (and the arena counters) as one float64
    tensor, for one copy to the host: float32 poses and int32 counts are
    exact in float64."""
    cols = [results.pose.q.to(torch.float64), results.pose.t.to(torch.float64)]
    cols += [getattr(results, f).to(torch.float64)[:, None]
             for f in _PACKED if getattr(results, f) is not None]
    flat = torch.cat(cols, dim=1).reshape(-1)
    if counters is not None:
        flat = torch.cat([flat, counters.to(torch.float64)])
    return flat


class SlamSystem:
    """Host-side orchestration: frame feed, trajectory collection, the
    local-BA backend, loop closure, relocalization and map maintenance.

    The positional parameters are the JAX engine's, in its order; the
    port's own, `device` and `sampler`, are keyword-only.
    `device` (default "cuda"; RuntimeError when there is no CUDA device)
    holds the map arena, the tracking state and every per-frame tensor; on
    "cuda" the FAST and Hamming 2-NN kernels run, on "cpu" their plain
    versions.  As in the JAX engine, `PRNGKey(seed)` is split once per
    frame (once per chunk on the chunked path), per loop keyframe and per
    relocalization attempt, and the RANSAC triplets are JAX's draws from
    those keys (utils/prng.py): a seed takes the JAX engine's decisions.
    `sampler(valid, n_hyp) -> [n_hyp, 3]`, when given, draws every triplet
    in their place; the keys are split all the same, so a checkpoint
    carries the key JAX's would.

    As in the JAX engine, local BA runs every `ba_every` new keyframes
    (`enable_backend`), inline (`ba_mode="sync"`) or solved on the CPU
    and merged at the next keyframe (`"async"`, backend/executor.py);
    `enable_loop_closure` and `enable_relocalization` run the loop
    pipeline (loop/pipeline.py).

    `process_chunk*` and `run(chunk=...)` take the chunked path: the scan
    (`make_slam_scan`), one results fetch per chunk, and the keyframe-rate
    work off the chunk's flags.  `defer_chunk_sync=True` pipelines it as
    the JAX engine does: chunk N's fetch and bookkeeping run after chunk
    N+1's launches, and its loop verifications resolve at the next chunk's
    entry.

    Whether the map is empty (the tracker's bootstrap) is a host flag, set
    after the first frame; an arena assigned to a fresh system is read
    once, at its first frame.

    `component_names` picks the detector, matcher and pnp from the
    registry (models/components.py; kinds left out take the defaults),
    composed into the step.  `params` (utils/params.ParameterRegistry)
    holds four tracker and backend thresholds: setting one rebuilds the
    components and the step around the new config.  Observers registered
    with `register_frame_observer` hear of every frame after its
    bookkeeping; on the deferred chunked path, of chunk N's frames once
    chunk N+1 was launched."""

    def __init__(self, cfg: Optional[SlamConfig] = None, seed: int = 0,
                 enable_backend: bool = True, ba_every: int = 1,
                 enable_loop_closure: bool = False,
                 enable_relocalization: bool = False,
                 component_names: Optional[dict] = None,
                 ba_mode: str = "sync",
                 defer_chunk_sync: bool = False, *, device="cuda",
                 sampler: Optional[Sampler] = None):
        self.device = _resolve_device(device)
        self.cfg = cfg or SlamConfig()
        self.cam = camera_from_config(self.cfg.camera, self.device)
        self.arena: MapArena = empty_arena(self.cfg.map, self.device)
        self.state: TrackState = initial_state(self.device)
        self._key = prng_key(seed)
        self.sampler: Optional[Sampler] = sampler
        # registry-selected components; the names are kept so a parameter
        # change rebuilds the same selection (imported here: the models
        # package imports this module)
        from modular_slam_tpu_torch.models.components import (
            build_components)

        self._component_names = dict(component_names or {})
        self.components = build_components(self.cfg, self._component_names)
        self.component_names = self.components.names
        self._step = make_slam_step(self.cfg, self.components,
                                    device=self.device)
        # None: not known yet, read from the arena at the next frame
        self._has_map: Optional[bool] = None
        self._scan = None                 # the chunked scan, built lazily
        self._scan_takes_db = False
        self.trajectory: List[Tuple[float, Pose]] = []
        self.results: List[TrackResult] = []
        self.last_features: Optional[Features] = None
        self._frame_observers: List[Callable] = []
        self.enable_backend = enable_backend
        self.ba_every = ba_every
        self.ba_mode = ba_mode  # "sync" (inline) | "async" (offloaded)
        self._kf_since_ba = 0
        self._backend = None  # BackendExecutor, built on first use
        self.n_compactions = 0
        # deferred chunk pipelining (see _process_chunk_core)
        self.defer_chunk_sync = defer_chunk_sync
        self._pending_chunk = None
        # per-chunk pool growth (kf, lm, obs): the deferred path's
        # maintenance check reads counters one chunk stale and advances
        # the highwater trigger by this much (see _maybe_compact)
        self._chunk_growth = (0, 0, 0)
        self._prev_counters = None
        # global-BA polish boundaries left after a deferred closure
        self._polish_burst = 0
        self.enable_loop_closure = enable_loop_closure
        self.enable_relocalization = enable_relocalization
        self._loop = None
        self.n_loop_closures = 0
        self.n_relocalizations = 0
        if enable_loop_closure or enable_relocalization:
            from modular_slam_tpu_torch.loop.pipeline import LoopPipeline

            self._loop = LoopPipeline(self.cfg, device=self.device)
        # runtime parameters: key -> (config section, field, cast)
        self.params = ParameterRegistry()
        self._param_map = {
            "min_matched_points": ("tracker", "min_matched_points", int),
            "better_keyframe_landmarks":
                ("tracker", "better_keyframe_landmarks", int),
            "new_keyframe_min_landmarks":
                ("tracker", "new_keyframe_min_inliers", int),
            "lba_max_num_iterations": ("backend", "max_iterations", int),
        }
        t = self.cfg.tracker
        self.params.register_number("min_matched_points",
                                    t.min_matched_points, 0, 1000)
        self.params.register_number("better_keyframe_landmarks",
                                    t.better_keyframe_landmarks, 0, 2000)
        self.params.register_number("new_keyframe_min_landmarks",
                                    t.new_keyframe_min_inliers, 0, 2000)
        self.params.register_number("lba_max_num_iterations",
                                    self.cfg.backend.max_iterations, 1, 100)
        self.params.subscribe_on_change(self._on_param_change)

    def _on_param_change(self, key: str, value) -> None:
        """Live-tune a config threshold: rebuild the components and the
        step around the new config, drop the scan (rebuilt at the next
        chunk) and close the backend (rebuilt at the next keyframe)."""
        from modular_slam_tpu_torch.models.components import (
            build_components)

        section, field, cast = self._param_map[key]
        sub = dataclasses.replace(getattr(self.cfg, section),
                                  **{field: cast(value)})
        self.cfg = dataclasses.replace(self.cfg, **{section: sub})
        self.components = build_components(self.cfg, self._component_names)
        self._step = make_slam_step(self.cfg, self.components,
                                    device=self.device)
        self._scan = None
        if self._backend is not None:
            self._backend.close()
            self._backend = None

    def register_frame_observer(self, fn: Callable) -> None:
        """fn(timestamp, pose, result), called after each processed frame."""
        self._frame_observers.append(fn)

    def _bootstrap_next(self) -> bool:
        """Whether the next frame bootstraps the map: read from the arena
        only while unknown (a new system, or an arena carried in)."""
        if self._has_map is None:
            self._has_map = int(self.arena.n_kf) > 0
        return not self._has_map

    def _next_key(self, num: Optional[int] = None):
        """Split the system's key as the JAX engine does before each use:
        -> the subkey (`num` keys split from it, for a chunk), or the
        injected sampler in their place."""
        self._key, sub = split(self._key)
        if self.sampler is not None:
            return self.sampler
        return sub if num is None else split(sub, num)

    def process(self, rgb: np.ndarray, depth: np.ndarray,
                timestamp: float) -> SlamResult:
        self._flush_pending_chunk()        # a deferred chunk, if mixing paths
        frame = frame_to_device(rgb, depth, timestamp, self.device)
        self.arena, self.state, result, feats = self._step(
            self.arena, self.state, frame.gray, frame.depth,
            frame.timestamp, self._next_key(), self._bootstrap_next())
        self._has_map = True
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
                    self.arena, self.state, kf_slot, feats, self._next_key(),
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
                                                  feats, self._next_key())
            if ok:
                self.state = new_state
                self.n_relocalizations += 1
        for fn in self._frame_observers:
            fn(timestamp, pose, result)
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
        """Complete all pending work — a deferred chunk's bookkeeping, any
        in-flight async local BA, any queued closure decision and a queued
        global-BA polish (end of a sequence, before reading the map out)."""
        self._flush_pending_chunk()
        self._harvest_ba()
        self._resolve_pending_closures()
        if self._loop is not None and self._loop._gba_pending:
            kf = self._loop._prev_kf
            if kf is not None:
                self.arena, self.state = self._loop.maybe_run_pending_gba(
                    self.arena, self.state, kf)

    def _resolve_pending_closures(self, counters=None) -> bool:
        """Decide the loop pipeline's queued verifications, counting the
        closures; -> whether any landed."""
        if self._loop is None or not self._loop.has_pending_closure:
            return False
        self.arena, self.state, closed = self._loop.resolve_pending(
            self.arena, self.state, counters)
        if closed:
            self.n_loop_closures += 1
        return closed

    def _read_counters(self) -> Tuple[int, int, int]:
        """(n_kf, n_lm, n_obs) in one host read."""
        return tuple(int(x) for x in torch.stack(
            [self.arena.n_kf, self.arena.n_lm, self.arena.n_obs]).cpu())

    def _maybe_compact(self, counters=None) -> bool:
        """Keyframe-rate map maintenance (map/lifecycle.py): when a pool
        crosses its highwater mark, cull weak landmarks, evict keyframes
        down to `kf_evict_target` of the pool and compact the slots, so the
        freed tail keeps accepting insertions.  The tracker's reference
        keyframe and the loop pipeline's slot-aligned structures are
        remapped.

        `counters` (n_kf, n_lm, n_obs) may come pre-fetched with a chunk's
        results (the deferred path); they lag the arena by the chunk in
        flight, so the trigger is advanced by the last chunk's growth.
        Without them, one host read."""
        m = self.cfg.map
        K, L, O = m.max_keyframes, m.max_landmarks, m.max_observations
        stale = counters is not None
        if counters is None:
            counters = self._read_counters()
        n_kf, n_lm, n_obs = (int(x) for x in counters)
        g_kf, g_lm, g_obs = self._chunk_growth if stale else (0, 0, 0)
        if (n_kf + g_kf < m.highwater * K and n_lm + g_lm < m.highwater * L
                and n_obs + g_obs < m.highwater * O):
            return False
        # ordering invariant: no chunk may be pending when the slots move.
        # Its results carry kf_slots of the arena before compaction, and
        # its bookkeeping (BA, BoW, edges, closures) would run against
        # remapped slots.  Finishing it first may compact (its own check
        # runs with nothing pending); the fresh counters then say whether
        # anything is left to do.
        if self._pending_chunk is not None:
            self._flush_pending_chunk()
            n_kf, n_lm, n_obs = self._read_counters()
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

    # -- chunked engine loop (throughput path) -------------------------------
    def process_chunk_device(self, grays: Tensor, depths: Tensor,
                             times) -> List[SlamResult]:
        """`process_chunk` for frames already on the device: grays and
        depths [C, H, W] float32, times [C] seconds (host list or array)."""
        times_host = [float(t) for t in np.asarray(times)]
        return self._process_chunk_core(
            grays, depths, upload(np.asarray(times_host, np.float32),
                                   self.device), times_host)

    def process_chunk_wire(self, grays_u8, depths_u16,
                           timestamps) -> List[SlamResult]:
        """The fewest bytes on the way to the card: 8-bit luma and raw
        16-bit depth, one copy each for the chunk, converted there to
        float32 luma and depth in metres (times `depth_factor`)."""
        times_host = [float(t) for t in timestamps]
        g8 = upload(np.stack([np.asarray(g, np.uint8) for g in grays_u8]),
                     self.device)
        # uint16 rides as int16 (the same bytes) and is widened on the card
        d16 = upload(np.stack([np.asarray(d, np.uint16)
                                for d in depths_u16]).view(np.int16),
                      self.device)
        grays = g8.to(torch.float32)
        deps = (d16.to(torch.int32) & 0xFFFF).to(torch.float32) * float(
            self.cfg.camera.depth_factor)
        return self._process_chunk_core(
            grays, deps, upload(np.asarray(times_host, np.float32),
                                 self.device), times_host)

    def process_chunk(self, rgbs, depths, timestamps) -> List[SlamResult]:
        """Process C frames as one chunk: one host->device copy per
        modality, the scan with no host read, then ONE fetch of the
        chunk's results and the keyframe-rate work (loop closure,
        relocalization at the boundary, local BA, maintenance) off its
        keyframe flags.  Against `process`, BA and loop corrections land
        after the chunk instead of mid-chunk.  Luma is `rgb_to_luma`, so
        the grays equal `process`'s bit for bit."""
        rgb = upload(np.stack([np.asarray(r) for r in rgbs]), self.device)
        deps = upload(np.stack([np.asarray(d, np.float32) for d in depths]),
                       self.device)
        times_host = [float(t) for t in timestamps]
        return self._process_chunk_core(
            rgb_to_luma(rgb), deps,
            upload(np.asarray(times_host, np.float32), self.device),
            times_host)

    def _process_chunk_core(self, grays, deps, times,
                            times_host) -> List[SlamResult]:
        if self._scan is None:
            # in-scan relocalization: a lost frame recovers on the next
            # frame instead of at a chunk boundary
            vocab = (self._loop._vocab
                     if self.enable_relocalization and self._loop is not None
                     else None)
            self._scan = make_slam_scan(self.cfg, self.components,
                                        with_features=self._loop is not None,
                                        reloc_vocab=vocab,
                                        device=self.device)
            self._scan_takes_db = vocab is not None
        keys = self._next_key(len(times_host))
        # merge the solve dispatched during the previous chunk before this
        # chunk's scan reads the arena
        self._harvest_ba()
        # resolve parked closure verifications before the scan: their
        # results were computed while the last chunk tracked, and the
        # PGO / global BA / fusion chain queues ahead of this chunk
        if self._loop is not None:
            if self._resolve_pending_closures(self._prev_counters):
                # a deferred closure lands a chunk late, after several
                # keyframes took drifted poses: a burst of global-BA
                # polishes over the next boundaries grinds that out
                if self.cfg.loop.global_ba_on_loop:
                    self._polish_burst = self.cfg.loop.deferred_polish_burst
            if (self._polish_burst > 0 or self._loop._gba_pending) \
                    and self._loop._prev_kf is not None:
                if self._polish_burst > 0:
                    self._loop._gba_pending = True
                before = self._loop.n_global_ba
                self.arena, self.state = self._loop.maybe_run_pending_gba(
                    self.arena, self.state, self._loop._prev_kf,
                    counters=self._prev_counters)
                if self._polish_burst > 0 \
                        and self._loop.n_global_ba > before:
                    self._polish_burst -= 1
        db = (self._loop.db,) if self._scan_takes_db else ()
        self.arena, self.state, out = self._scan(
            self.arena, self.state, *db, grays, deps, times, keys,
            bootstrap=self._bootstrap_next())
        self._has_map = True
        results = out[0] if self._loop is not None else out

        if self.defer_chunk_sync:
            # pipelined: the device runs this chunk while the host finishes
            # the previous one; keyframe-rate work lands one chunk late.
            # The arena counters ride with the results fetch.
            counters = torch.stack(
                [self.arena.n_kf, self.arena.n_lm, self.arena.n_obs])
            pending = self._pending_chunk
            self._pending_chunk = (out, times_host, _HostFetch(
                _pack_results(results, counters)))
            if pending is None:
                return []
            return self._finish_chunk(*pending)
        return self._finish_chunk(out, times_host,
                                  _HostFetch(_pack_results(results, None)))

    def _flush_pending_chunk(self) -> List[SlamResult]:
        """Finish the deferred chunk (end of a sequence, before reading
        state out, before a per-frame `process`)."""
        if self._pending_chunk is None:
            return []
        pending, self._pending_chunk = self._pending_chunk, None
        return self._finish_chunk(*pending)

    def _finish_chunk(self, out, times_host, fetch: _HostFetch
                      ) -> List[SlamResult]:
        C = len(times_host)
        results, feats = out if self._loop is not None else (out, None)

        # ---- the chunk's one results fetch ---------------------------------
        host = fetch.wait()
        has_reloc = results.relocalized is not None
        ncol = 7 + len(_PACKED) - (0 if has_reloc else 1)
        cols = torch.from_numpy(host[:C * ncol].reshape(C, ncol).copy())
        counters_h = None
        if host.shape[0] > C * ncol:
            counters_h = tuple(int(x) for x in host[C * ncol:])
        q, t = cols[:, :4].to(torch.float32), cols[:, 4:7].to(torch.float32)
        ok = cols[:, 7] > 0
        new_kf = cols[:, 8] > 0
        ints = cols[:, 9:12].to(torch.int32)
        ok_np, n_i = ok.numpy(), ints[:, 2].numpy()
        relocd = cols[:, 12] > 0 if has_reloc else None
        if has_reloc:
            self.n_relocalizations += int(relocd.sum())
            self._loop.n_reloc_attempts += int((~ok).sum())
        if counters_h is not None:
            # per-chunk pool growth for the stale-counter margin of
            # _maybe_compact; compaction shrinks counters, hence the max
            if self._prev_counters is not None:
                self._chunk_growth = tuple(
                    max(c - p, 0)
                    for c, p in zip(counters_h, self._prev_counters))
            self._prev_counters = counters_h

        codes: List[SlamResult] = []
        for i in range(C):
            pose = Pose(q=q[i], t=t[i])
            self.trajectory.append((times_host[i], pose))
            self.results.append(TrackResult(
                pose=pose, n_matches=ints[i, 1], n_inliers=ints[i, 2],
                tracking_ok=ok[i], new_keyframe=new_kf[i],
                kf_slot=ints[i, 0],
                relocalized=None if relocd is None else relocd[i]))
            for fn in self._frame_observers:
                fn(times_host[i], pose, self.results[-1])
            codes.append(SlamResult.SUCCESS if ok_np[i]
                         else SlamResult.NO_CONSTRAINTS)

        # ---- keyframe-rate work off the chunk's flags ----------------------
        for i in np.nonzero(new_kf.numpy())[0]:
            kf_slot = int(ints[i, 0])
            if self._loop is not None:
                # in-flight BA lands before any pose-graph correction
                self._harvest_ba()
                self.arena, self.state, closed = self._loop.on_new_keyframe(
                    self.arena, self.state, kf_slot, feats[i],
                    self._next_key(),
                    run_loop_detection=self.enable_loop_closure,
                    # pipelined: park the verification instead of reading
                    # it behind the chunk in flight
                    defer_closure=self.defer_chunk_sync,
                    counters=counters_h)
                if closed:
                    self.n_loop_closures += 1
            if self.enable_backend:
                self._kf_since_ba += 1
                if self._kf_since_ba >= self.ba_every:
                    self._run_local_ba(kf_slot)
                    self._kf_since_ba = 0

        # ---- relocalization at the chunk boundary --------------------------
        # when the in-scan attempts failed (the rescuing keyframe entered
        # the database after the scan started): the chunk's last frame
        # first, then its first lost frame, whose view may match the map
        # when the last one does not
        if (_should_relocalize(ok_np, n_i,
                               self.cfg.tracker.new_keyframe_min_inliers)
                and self.enable_relocalization and feats is not None):
            lost = np.nonzero(~ok_np)[0]
            try_frames = [C - 1]
            if len(lost) and int(lost[0]) != C - 1:
                try_frames.append(int(lost[0]))
            for fi in try_frames:
                new_state, r_ok = self._loop.relocalize(
                    self.arena, self.state, feats[fi], self._next_key())
                if r_ok:
                    self.state = new_state
                    self.n_relocalizations += 1
                    break

        # ---- map maintenance at the chunk boundary -------------------------
        if new_kf.any():
            self._maybe_compact(counters_h)
        return codes

    def run(self, dataset, writer=None, max_frames: Optional[int] = None,
            chunk: int = 1):
        """Process an iterable of (rgb, depth, timestamp) frames, streaming
        poses to `writer` (`.write(timestamp, pose)`) when given.
        `chunk > 1` takes the chunked path; a final partial chunk runs
        frame by frame.  Ends with `flush_backend()`.  -> the trajectory,
        a list of (timestamp, Pose)."""
        written = 0

        def drain_writer():
            # a cursor: chunk results may land late (deferred pipelining)
            # or two chunks at once (a maintenance flush)
            nonlocal written
            if writer is None:
                return
            while written < len(self.trajectory):
                writer.write(*self.trajectory[written])
                written += 1

        buf = []
        for i, frame in enumerate(dataset):
            if max_frames is not None and i >= max_frames:
                break
            if chunk <= 1:
                self.process(*frame)
                drain_writer()
                continue
            buf.append(frame)
            if len(buf) == chunk:
                self.process_chunk(*zip(*buf))
                drain_writer()
                buf = []
        for frame in buf:
            self.process(*frame)
        self.flush_backend()
        drain_writer()
        return self.trajectory

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
        n_kf, n_lm, n_obs = self._read_counters()
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
