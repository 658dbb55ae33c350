"""Fixed-capacity tensor map arena: keyframes, landmarks, observations,
covisibility (counterpart of modular_slam_tpu/map/arena.py).

Preallocated pools with validity masks plus a [K, L] boolean observation
incidence matrix; covisibility queries are masked matrix-vector products.

Overflow policy as in JAX: writes beyond capacity are dropped and the
counters saturate.  JAX's `.at[...].set(mode="drop")` has no torch
counterpart, so `_set_rows` selects the kept rows and copies only those.
Unlike the functional JAX arena, the `add_*` functions update the arena's
tensors IN PLACE (they return the arena with new counters): the engine
holds one arena and never reads an old one, so no copy of the 8 MB of
incidence and descriptors is made per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from modular_slam_tpu_torch.config import MapConfig
from modular_slam_tpu_torch.geometry.se3 import Pose

Tensor = torch.Tensor


class MapArena(NamedTuple):
    # keyframe pool [K]
    kf_q: Tensor          # [K, 4] camera-to-world quats (wxyz)
    kf_t: Tensor          # [K, 3]
    kf_time: Tensor       # [K] float32
    kf_valid: Tensor      # [K] bool
    # landmark pool [L]
    lm_pos: Tensor        # [L, 3] world positions
    lm_desc: Tensor       # [L, D] int8 ±1 — most recent observation
    lm_valid: Tensor      # [L] bool
    # observation incidence [K, L] bool
    inc: Tensor
    # observation COO edge list [O]
    obs_kf: Tensor        # [O] int32
    obs_lm: Tensor        # [O] int32
    obs_uv: Tensor        # [O, 2] float32 (level-0 pixels)
    obs_depth: Tensor     # [O] float32 (meters, 0 = no depth)
    obs_valid: Tensor     # [O] bool
    # counters (0-d int32, saturating)
    n_kf: Tensor
    n_lm: Tensor
    n_obs: Tensor

    @property
    def max_keyframes(self) -> int:
        return self.kf_q.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def max_observations(self) -> int:
        return self.obs_kf.shape[0]


def empty_arena(cfg: MapConfig, device="cpu") -> MapArena:
    K, L, O, D = (cfg.max_keyframes, cfg.max_landmarks,
                  cfg.max_observations, cfg.descriptor_bits)
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    kf_q = z((K, 4), f32)
    kf_q[:, 0] = 1.0
    return MapArena(
        kf_q=kf_q, kf_t=z((K, 3), f32), kf_time=z((K,), f32),
        kf_valid=z((K,), torch.bool),
        lm_pos=z((L, 3), f32), lm_desc=z((L, D), torch.int8),
        lm_valid=z((L,), torch.bool),
        inc=z((K, L), torch.bool),
        obs_kf=z((O,), i32), obs_lm=z((O,), i32), obs_uv=z((O, 2), f32),
        obs_depth=z((O,), f32), obs_valid=z((O,), torch.bool),
        n_kf=z((), i32), n_lm=z((), i32), n_obs=z((), i32),
    )


def _set_rows(dst: Tensor, rows: Tensor, src: Tensor, keep: Tensor) -> None:
    """dst[rows[i]] = src[i] where keep[i]; other rows are dropped.  The
    kept rows are distinct (fresh slots or deduplicated matches), so the
    copy is deterministic."""
    sel = torch.nonzero(keep).squeeze(1)
    dst.index_copy_(0, rows[sel].long(), src[sel].to(dst.dtype))


def add_keyframe(arena: MapArena, pose: Pose,
                 time: Tensor) -> Tuple[MapArena, Tensor]:
    """Append a keyframe; returns (arena, slot) with slot == K when the
    pool is full (nothing is written then)."""
    K = arena.max_keyframes
    slot = arena.n_kf
    has_room = slot < K
    one = has_room.reshape(1)
    rows = slot.reshape(1)
    _set_rows(arena.kf_q, rows, pose.q[None], one)
    _set_rows(arena.kf_t, rows, pose.t[None], one)
    _set_rows(arena.kf_time, rows, time.reshape(1), one)
    _set_rows(arena.kf_valid, rows, one, one)
    arena = arena._replace(n_kf=torch.clamp(arena.n_kf + 1, max=K))
    return arena, torch.where(has_room, slot, torch.full_like(slot, K))


def add_landmarks(arena: MapArena, positions: Tensor, descs: Tensor,
                  valid: Tensor) -> Tuple[MapArena, Tensor]:
    """Batch-insert landmarks [N]; returns (arena, slots [N]) with
    slot == L for dropped/invalid rows."""
    L = arena.max_landmarks
    order = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    big = torch.full_like(order, L)
    slots = torch.where(valid, arena.n_lm + order, big)
    slots = torch.where(slots < L, slots, big)
    keep = slots < L
    _set_rows(arena.lm_pos, slots, positions, keep)
    _set_rows(arena.lm_desc, slots, descs, keep)
    _set_rows(arena.lm_valid, slots, keep, keep)
    n_lm = torch.clamp(arena.n_lm + torch.sum(valid.to(torch.int32)), max=L)
    return arena._replace(n_lm=n_lm.to(torch.int32)), slots


def add_observations(arena: MapArena, kf_slot: Tensor, lm_slots: Tensor,
                     uv: Tensor, depth: Tensor, descs: Tensor,
                     valid: Tensor) -> MapArena:
    """Record keyframe -> landmark observations: COO rows, incidence bits
    and the most-recent-descriptor refresh."""
    L = arena.max_landmarks
    O = arena.max_observations
    ok = valid & (lm_slots < L) & (kf_slot < arena.max_keyframes)

    order = torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32) - 1
    big = torch.full_like(order, O)
    rows = torch.where(ok, arena.n_obs + order, big)
    rows = torch.where(rows < O, rows, big)
    in_obs = rows < O
    kf_full = kf_slot.to(torch.int32).expand(lm_slots.shape)

    _set_rows(arena.obs_kf, rows, kf_full, in_obs)
    _set_rows(arena.obs_lm, rows, lm_slots, in_obs)
    _set_rows(arena.obs_uv, rows, uv, in_obs)
    _set_rows(arena.obs_depth, rows, depth, in_obs)
    _set_rows(arena.obs_valid, rows, ok, in_obs)
    # incidence row of this keyframe and the descriptor refresh: ok rows
    # only (their slots are distinct and in range)
    sel = torch.nonzero(ok).squeeze(1)
    lm_sel = lm_slots[sel].long()
    arena.inc[kf_slot.long().clamp(max=arena.max_keyframes - 1), lm_sel] = True
    arena.lm_desc.index_copy_(0, lm_sel, descs[sel])
    n_obs = torch.clamp(arena.n_obs + torch.sum(ok.to(torch.int32)), max=O)
    return arena._replace(n_obs=n_obs.to(torch.int32))


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def khop_keyframes(arena: MapArena, kf_slot: Tensor, depth: int) -> Tensor:
    """[K] bool — keyframes within `depth` covisibility hops of kf_slot
    (inclusive).  One hop is "landmarks seen by the visited set, then
    keyframes seeing those landmarks": two [K, L] float32 GEMVs.  The JAX
    package uses bf16 inputs on the TPU; float32 here, and 0/1 sums are
    exact either way."""
    K = arena.max_keyframes
    inc_f = arena.inc.to(torch.float32)
    ids = torch.arange(K, device=arena.inc.device)
    visited = (ids == kf_slot) & arena.kf_valid
    for _ in range(depth):
        lm_hit = visited.to(torch.float32) @ inc_f                  # [L]
        back = inc_f @ (lm_hit > 0).to(torch.float32)               # [K]
        visited = (visited | (back > 0)) & arena.kf_valid
    return visited


def visible_landmarks(arena: MapArena, kf_mask: Tensor) -> Tensor:
    """[L] bool — landmarks observed by any keyframe in kf_mask."""
    hits = torch.any(arena.inc & kf_mask[:, None], dim=0)
    return hits & arena.lm_valid
