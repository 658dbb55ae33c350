"""Loop closure and relocalization, orchestrated from the host at
keyframe rate (counterpart of modular_slam_tpu/loop/pipeline.py).

Per new keyframe: the BoW vector goes into the database, an odometry edge
joins it to the previous keyframe, and — outside the cooldown after a
closure — the database is queried and the `top_k` candidates verified
geometrically (one batched K2 launch, loop/detector.py).  The first
candidate that clears the score gate and verifies closes the loop: a loop
edge with the measured pose, pose-graph optimization (PGO) with a rigid
landmark correction, a global BA at the compact tier of the live map, and
the fusion of the landmarks re-created on the revisit; a global-BA polish
of the fused graph is then queued for the next keyframe (or `flush`).
After tracking loss, `relocalize` queries the database and verifies as
well.

Host reads, as in JAX: one copy of the query and verification results per
closure decision, and one `bool(ok)` per relocalization attempt (plus the
tier's counters before a global BA).

No counterpart: the JAX pipeline compiles global-BA tiers ahead of time on
background threads and defers a closure's global BA while its tier
compiles (`_compile_tier_async`, `_prewarm_successor_tiers`,
`start_background_prewarm`, `prewarm_for_counts`).  PyTorch has no compile
step: a tier's solver (`make_global_ba_compact`) is built on first use and
cached, so a global BA is never deferred (`n_gba_deferred` stays 0) and
`_gba_pending` is set only by the post-fuse polish.

`defer_closure=True` (the engine's deferred chunk path) parks a
keyframe's verification without reading it; `resolve_pending` decides the
queue later, re-checking the cooldown then.

A keyframe the full pool dropped (slot K, which happens only in a pool of
fewer than 3 keyframes, one eviction cannot shrink) goes through the same
steps as in JAX, whose gathers clamp it to slot K - 1 and whose scatters
drop it: the reads here take slot K - 1, the BoW row and the pose-graph
edges that name slot K are not written, and the counters (`_n_edges`,
`_prev_kf`, `_kf_counter`) move as in JAX.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from modular_slam_tpu_torch.backend.ba import (global_ba_tier_counts,
                                               make_global_ba_compact,
                                               tier_from_counts)
from modular_slam_tpu_torch.backend.posegraph import (
    PoseGraphEdges, add_edge, correct_landmarks, empty_edges,
    optimize_pose_graph, refresh_odometry_edges)
from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import _resolve_device
from modular_slam_tpu_torch.frontend.tracker import TrackState
from modular_slam_tpu_torch.geometry.camera import camera_from_config
from modular_slam_tpu_torch.geometry.se3 import (Pose, pose_compose,
                                                 pose_inverse)
from modular_slam_tpu_torch.loop.detector import (LoopDatabase,
                                                  add_keyframe_bow,
                                                  empty_database,
                                                  geometric_verify,
                                                  query_candidates,
                                                  relative_pose)
from modular_slam_tpu_torch.loop.relocalizer import make_relocalizer
from modular_slam_tpu_torch.loop.vocab import (bow_histogram,
                                               load_trained_vocab)
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.map.lifecycle import (SlotRemaps,
                                                  fuse_duplicate_landmarks)
from modular_slam_tpu_torch.types import Features
from modular_slam_tpu_torch.utils.prng import split

Tensor = torch.Tensor

LOOP_EDGE_WEIGHT = 2.0
STAGES = ("bow", "query", "verify", "pgo", "global_ba", "fuse")


def _delta_apply(old: Pose, new: Pose, live: Pose) -> Pose:
    """Apply the world-frame correction new * old^-1 to a live pose — the
    transform PGO or global BA applied to the loop keyframe, carried onto
    the tracker's current pose."""
    return pose_compose(pose_compose(new, pose_inverse(old)), live)


def _kf_pose(arena: MapArena, slot: int) -> Pose:
    """A copy of keyframe `slot`'s pose (the arena is updated in place);
    slot K reads K - 1, as the JAX gather clamps it."""
    slot = min(slot, arena.max_keyframes - 1)
    return Pose(q=arena.kf_q[slot].clone(), t=arena.kf_t[slot].clone())


def _add_edge(edges: PoseGraphEdges, idx: int, i: int, j: int, rel: Pose,
              weight: float, K: int, is_loop: bool = False) -> None:
    """`add_edge`, dropped when an endpoint is a keyframe the full pool
    dropped (slot K; JAX writes it, and its next compaction deactivates
    it)."""
    if i < K and j < K:
        add_edge(edges, idx, i, j, rel, weight, is_loop=is_loop)


def solve_pose_graph(kf_q: Tensor, kf_t: Tensor, kf_valid: Tensor,
                     edges: PoseGraphEdges, lcfg
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """The loop closure's PGO: odometry edges re-measured from the current
    poses (so it distributes only the loop correction), then
    `optimize_pose_graph` on the LoopConfig's schedule -> (kf_q, kf_t,
    cost) in the poses' dtype.

    Solved in float64: a loop correction spreads along a chain whose cost
    changes by ~1e-6 relative over 2e-4 m of pose, so float32 Gauss-Newton
    stops wherever its rounding hides the slope — 1.8e-4 m from the
    float64 optimum on chip_smoke.py's 26-keyframe loop, and at a
    different place on the card than on the CPU.  In float64 both reach
    the optimum (the JAX package solves in float32; its result lies within
    that 2e-4)."""
    f64 = torch.float64
    e64 = PoseGraphEdges(*(x.to(f64) if x.is_floating_point() else x
                           for x in edges))
    q64, t64 = kf_q.to(f64), kf_t.to(f64)
    q, t, cost = optimize_pose_graph(
        q64, t64, kf_valid, refresh_odometry_edges(e64, q64, t64),
        iters=lcfg.pgo_iterations, cg_iters=lcfg.pgo_cg_iters)
    return q.to(kf_q.dtype), t.to(kf_t.dtype), cost.to(kf_t.dtype)


class LoopPipeline:
    """Loop closure and relocalization state: the BoW database, the
    pose-graph edges, the closure log and the cached global-BA tiers, on
    `device` (keyword-only; default "cuda"; RuntimeError without a CUDA
    device).

    `profile=True` ends every stage with a device synchronize and records
    its wall ms in `stage_ms` (bow, query, verify: every keyframe; pgo,
    global_ba, fuse: every closure).  `closures` logs accepted closures as
    (cur_kf_slot, cand_kf_slot, n_inliers, bow_score, measured query
    position); `n_verify_rejects` counts gated candidates that failed
    verification; `n_verify_dispatches` and `n_reloc_attempts` count the
    batched verifications, one K2 launch each."""

    def __init__(self, cfg: SlamConfig, profile: bool = False, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = _resolve_device(device)
        self.profile = profile
        self.stage_ms: Dict[str, List[float]] = {k: [] for k in STAGES}
        self.closures: List[tuple] = []
        self.n_verify_rejects = 0
        self.n_verify_dispatches = 0
        self.n_reloc_attempts = 0
        self.cam = camera_from_config(cfg.camera, self.device)
        self.set_vocab(load_trained_vocab(cfg.loop.vocab_size))
        K = cfg.map.max_keyframes
        self.db = empty_database(K, cfg.loop.vocab_size, self.device)
        self.edges: PoseGraphEdges = empty_edges(4 * K, self.device)
        self._n_edges = 0
        self._prev_kf: Optional[int] = None
        # (Kt, Lt, Ot) -> compact global BA, built on first use
        self._gba_tiers: Dict[Tuple[int, int, int], object] = {}
        # the post-fuse polish of the last closure, run at the next
        # keyframe or flush
        self._gba_pending = False
        # verifications awaiting their host decision (FIFO); only the
        # chunked path defers them
        self._pending_verify: list = []
        self._kf_counter = 0
        self._last_closure_at = -(10 ** 9)
        self._t0 = time.perf_counter()       # start of the profiled stage
        self.n_gba_deferred = 0
        self.n_global_ba = 0
        self.last_gba_stats = None
        self._fused_acc = torch.zeros((), dtype=torch.int32,
                                      device=self.device)

    @property
    def n_fused_landmarks(self) -> int:
        """Duplicate landmarks fused so far (reads the device counter)."""
        return int(self._fused_acc)

    def set_vocab(self, vocab) -> None:
        """Swap the BoW codebook [V, 256] ±1.  The database histograms are
        only meaningful against the codebook that made them, so a restored
        map brings its own."""
        self._vocab = torch.as_tensor(np.asarray(vocab, np.int8),
                                      device=self.device)
        self._reloc = make_relocalizer(self.cfg, self._vocab)

    # ------------------------------------------------------------------
    def _query(self, db: LoopDatabase, hist: Tensor, slot: int,
               arena: MapArena) -> Tuple[Tensor, Tensor]:
        lcfg = self.cfg.loop
        # landmarks shared with every keyframe, exact (the JAX matvec is
        # bf16, which rounds counts above 256; the gate at max_covis is
        # far below)
        row = arena.inc[min(slot, arena.max_keyframes - 1)]
        covis = (arena.inc.to(torch.float32) @ row.to(torch.float32)).to(
            torch.int32)
        return query_candidates(
            db, hist, slot, lcfg.min_gap_keyframes, lcfg.top_k,
            gap_floor=lcfg.min_gap_floor, gap_fraction=lcfg.min_gap_fraction,
            covis_counts=covis, max_covis=lcfg.max_covis_overlap)

    def _verify_slots(self, arena: MapArena, scores: Tensor, slots: Tensor,
                      feats: Features, key):
        """Verification of all top-k query results in one dispatch, fed
        from the query output on the device; candidate b draws from
        `split(key, top_k)[b]`."""
        self.n_verify_dispatches += 1
        keys = split(key, slots.shape[0])
        ok, inl, poses = geometric_verify(arena, torch.clamp(slots, min=0),
                                          feats, self.cam, self.cfg, keys)
        ok = ok & (slots >= 0) & (scores >= self.cfg.loop.min_score)
        return ok, inl, poses

    def _mark(self, stage: str) -> None:
        """Profiling probe: synchronize and record the stage's wall ms."""
        if not self.profile:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stage_ms[stage].append((now - self._t0) * 1e3)
        self._t0 = now

    def on_new_keyframe(
        self, arena: MapArena, state: TrackState, kf_slot: int,
        feats: Features, key, run_loop_detection: bool = True,
        defer_closure: bool = False, counters=None,
    ) -> Tuple[MapArena, TrackState, bool]:
        """Keyframe-rate loop work; -> (arena, state, closed).  `key` is
        the keyframe's PRNG key (utils/prng.py), split as JAX splits it
        for the verification's RANSAC draws.

        `defer_closure`: park the verification (query results, ok,
        inliers, poses; nothing read back) for `resolve_pending`, and
        leave the queue to the caller — the deferred chunk path resolves
        it at the next chunk's entry.  `counters`: pre-fetched (n_kf,
        n_lm, n_obs) for the global-BA tier."""
        self._t0 = time.perf_counter()
        closed = False
        if not defer_closure:
            arena, state, closed = self.resolve_pending(arena, state,
                                                        counters)
        if self._gba_pending:
            arena, state = self.maybe_run_pending_gba(arena, state, kf_slot,
                                                      counters=counters)
        hist = bow_histogram(feats.descriptors.unpacked,
                             feats.keypoints.valid, self._vocab)
        add_keyframe_bow(self.db, kf_slot, hist)
        self._mark("bow")

        # odometry edge between consecutive keyframes
        if self._prev_kf is not None and self._prev_kf != kf_slot:
            rel = relative_pose(_kf_pose(arena, self._prev_kf),
                                _kf_pose(arena, kf_slot))
            _add_edge(self.edges, self._n_edges, self._prev_kf, kf_slot, rel,
                      1.0, arena.max_keyframes)
            self._n_edges += 1
        self._prev_kf = kf_slot

        self._kf_counter += 1
        in_cooldown = (self._kf_counter - self._last_closure_at
                       <= self.cfg.loop.closure_cooldown_keyframes)
        if run_loop_detection and not in_cooldown:
            scores, slots = self._query(self.db, hist, kf_slot, arena)
            self._mark("query")
            key, sub = split(key)
            ok_b, inl_b, poses_b = self._verify_slots(arena, scores, slots,
                                                      feats, sub)
            if defer_closure:
                self._pending_verify.append(
                    (self._kf_counter, kf_slot, scores, slots, ok_b, inl_b,
                     poses_b))
                return arena, state, closed
            arena, state, closed_now = self._finish_closure(
                arena, state, kf_slot, scores, slots, ok_b, inl_b, poses_b,
                counters)
            closed = closed or closed_now
        return arena, state, closed

    @property
    def has_pending_closure(self) -> bool:
        return bool(self._pending_verify)

    def resolve_pending(self, arena: MapArena, state: TrackState,
                        counters=None) -> Tuple[MapArena, TrackState, bool]:
        """Decide every queued verification (FIFO), entries (kf_ord,
        kf_slot, scores, slots, ok, inliers, poses), against the current
        arena; an entry dispatched before an earlier one closed falls in
        that closure's cooldown.  -> closed=True if any closure landed."""
        closed_any = False
        while self._pending_verify:
            kf_ord, kf_slot, *verified = self._pending_verify.pop(0)
            if (kf_ord - self._last_closure_at
                    <= self.cfg.loop.closure_cooldown_keyframes):
                continue
            arena, state, closed = self._finish_closure(
                arena, state, kf_slot, *verified, counters)
            closed_any = closed_any or closed
        return arena, state, closed_any

    def _finish_closure(self, arena, state, kf_slot: int, scores, slots,
                        ok_b, inl_b, poses_b, counters=None
                        ) -> Tuple[MapArena, TrackState, bool]:
        B = scores.shape[0]
        # the decision's one host read: scores, slots, ok, inliers and the
        # measured positions in one copy (slots and counts are exact in
        # float32)
        host = torch.cat([scores, slots.to(torch.float32),
                          ok_b.to(torch.float32), inl_b.to(torch.float32),
                          poses_b.t.reshape(-1)]).cpu()
        self._mark("verify")
        scores_h = host[:B].tolist()
        slots_h = [int(x) for x in host[B:2 * B]]
        ok_h = (host[2 * B:3 * B] > 0).tolist()
        inl_h = [int(x) for x in host[3 * B:4 * B]]
        t_h = host[4 * B:].reshape(B, 3).tolist()
        pick = None
        for i in range(B):
            if scores_h[i] < self.cfg.loop.min_score or slots_h[i] < 0:
                continue
            if ok_h[i]:
                pick = i
                break
            self.n_verify_rejects += 1
        if pick is None:
            return arena, state, False
        # the cooldown runs from the newest keyframe seen
        self._last_closure_at = self._kf_counter
        cand = slots_h[pick]
        self.closures.append((kf_slot, cand, inl_h[pick], scores_h[pick],
                              tuple(t_h[pick])))
        arena, live = self._close(arena, cand, kf_slot, poses_b.q[pick],
                                  poses_b.t[pick], self._n_edges, state.pose)
        self._n_edges += 1
        state = state._replace(pose=live)
        self._mark("pgo")
        if self.cfg.loop.global_ba_on_loop:
            arena, state = self._run_global_ba(arena, state, kf_slot,
                                               counters)
            self._mark("global_ba")
        # merge the revisit's re-created landmarks into the matched
        # keyframe's originals, now that PGO and global BA put them in one
        # frame; the count stays on the device (a dropped keyframe reads
        # slot K - 1, as the JAX gathers clamp it)
        m = self.cfg.map
        arena, n_fused = fuse_duplicate_landmarks(
            arena, min(kf_slot, arena.max_keyframes - 1), cand,
            max_dist=m.fusion_max_dist_m, max_hamming=m.fusion_max_hamming)
        self._fused_acc += n_fused
        self._mark("fuse")
        # fusion rewired the revisit's observations onto the originals:
        # polish the fused graph once more at the next keyframe or flush
        if self.cfg.loop.global_ba_on_loop and self.cfg.loop.post_fuse_polish:
            self._gba_pending = True
        return arena, state, True

    def _pgo(self, arena: MapArena, cur_kf: int
             ) -> Tuple[MapArena, Pose, Tensor]:
        """PGO over the edges, then every landmark moves rigidly with its
        anchor, the newest keyframe observing it.  Updates the arena in
        place."""
        q, t, cost = solve_pose_graph(arena.kf_q, arena.kf_t,
                                      arena.kf_valid, self.edges,
                                      self.cfg.loop)
        K = arena.max_keyframes
        rank = arena.inc.to(torch.int32) * torch.arange(
            1, K + 1, dtype=torch.int32, device=q.device)[:, None]
        anchor = torch.argmax(rank, dim=0)                       # [L]
        lm_new = correct_landmarks(arena.lm_pos, arena.lm_valid, anchor,
                                   arena.kf_q, arena.kf_t, q, t)
        arena.kf_q.copy_(q)
        arena.kf_t.copy_(t)
        arena.lm_pos.copy_(lm_new)
        cur = min(cur_kf, K - 1)
        return arena, Pose(q=q[cur], t=t[cur]), cost

    def _close(self, arena: MapArena, cand: int, cur_kf: int, meas_q: Tensor,
               meas_t: Tensor, edge_idx: int, live: Pose
               ) -> Tuple[MapArena, Pose]:
        """Loop edge (the measured pose relative to the candidate), PGO
        and landmark correction; the live pose gets the correction PGO
        applied to the loop keyframe."""
        old = _kf_pose(arena, cur_kf)
        rel = relative_pose(_kf_pose(arena, cand), Pose(q=meas_q, t=meas_t))
        _add_edge(self.edges, edge_idx, cand, cur_kf, rel, LOOP_EDGE_WEIGHT,
                  arena.max_keyframes, is_loop=True)
        arena, new_kf_pose, _ = self._pgo(arena, cur_kf)
        return arena, _delta_apply(old, new_kf_pose, live)

    # ------------------------------------------------------------------
    @staticmethod
    def _tier_for(arena: MapArena, counters=None):
        """(tier, counts): from pre-fetched counters with a 25 % margin for
        counts that lag the arena, else one host read."""
        if counters is None:
            return global_ba_tier_counts(arena)
        caps = (arena.max_keyframes, arena.max_landmarks,
                arena.max_observations)
        counts = tuple(int(c) for c in counters)
        tier = tier_from_counts(
            tuple(min(int(1.25 * c) + 1, cap)
                  for c, cap in zip(counts, caps)), caps)
        return tier, counts

    def _gba_for(self, tier: Tuple[int, int, int]):
        if tier not in self._gba_tiers:
            self._gba_tiers[tier] = make_global_ba_compact(self.cfg, tier,
                                                           self.device)
        return self._gba_tiers[tier]

    def maybe_run_pending_gba(self, arena: MapArena, state: TrackState,
                              kf_slot: int, wait: bool = False,
                              counters=None
                              ) -> Tuple[MapArena, TrackState]:
        """Run the queued global-BA polish, if any.  `wait` is JAX's
        (there it joins the tier's compile thread); the port compiles
        nothing in the background, so there is nothing to wait for and the
        polish always runs at once."""
        if not self._gba_pending:
            return arena, state
        tier, _ = self._tier_for(arena, counters)
        self._gba_pending = False
        return self._exec_global_ba(arena, state, kf_slot,
                                    self._gba_for(tier))

    def _run_global_ba(self, arena: MapArena, state: TrackState,
                       kf_slot: int, counters=None
                       ) -> Tuple[MapArena, TrackState]:
        """Loop-triggered global BA, compacted to the tier of the live
        map."""
        tier, _ = self._tier_for(arena, counters)
        return self._exec_global_ba(arena, state, kf_slot,
                                    self._gba_for(tier))

    def _exec_global_ba(self, arena, state, kf_slot: int, gba):
        # the live pose gets the correction global BA applies to the loop
        # keyframe; the old pose is copied first (the solve is in place)
        old = _kf_pose(arena, kf_slot)
        arena, stats = gba(arena)
        self.n_global_ba += 1
        self.last_gba_stats = stats
        live = _delta_apply(old, _kf_pose(arena, kf_slot), state.pose)
        return arena, state._replace(pose=live)

    # ------------------------------------------------------------------
    def remap_slots(self, remaps: SlotRemaps) -> None:
        """Compaction moved keyframe slots: remap the database rows and the
        edge endpoints (an edge with an evicted endpoint is deactivated)."""
        K = self.db.hists.shape[0]
        kf_map = remaps.kf.long()
        rows = kf_map[:K]
        hists = torch.zeros((K + 1, self.db.hists.shape[1]),
                            dtype=self.db.hists.dtype, device=rows.device)
        valid = torch.zeros(K + 1, dtype=torch.bool, device=rows.device)
        hists[rows] = self.db.hists
        valid[rows] = self.db.valid
        self.db = LoopDatabase(hists=hists[:K], valid=valid[:K])

        e = self.edges
        i2 = kf_map[torch.clamp(e.i.long(), 0, K)]
        j2 = kf_map[torch.clamp(e.j.long(), 0, K)]
        alive = (i2 < K) & (j2 < K) & (e.weight > 0)
        self.edges = e._replace(
            i=torch.where(alive, i2, 0).to(torch.int32),
            j=torch.where(alive, j2, 0).to(torch.int32),
            weight=torch.where(alive, e.weight, 0.0))
        if self._prev_kf is not None:
            new_prev = int(remaps.kf[self._prev_kf])
            self._prev_kf = new_prev if new_prev < K else None

    # ------------------------------------------------------------------
    def relocalize(self, arena: MapArena, state: TrackState, feats: Features,
                   key) -> Tuple[TrackState, bool]:
        """One relocalization attempt: -> (state at the recovered pose, or
        unchanged; whether it succeeded)."""
        self.n_reloc_attempts += 1
        ok, pose, slot, _ = self._reloc(arena, self.db, feats, key)
        if bool(ok):                      # the attempt's one host read
            return state._replace(pose=pose, ref_kf=slot, lost=~ok), True
        return state, False
