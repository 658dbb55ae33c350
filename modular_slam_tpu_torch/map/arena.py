"""Fixed-capacity tensor map arena: keyframes, landmarks, observations,
covisibility (counterpart of modular_slam_tpu/map/arena.py).

Preallocated pools with validity masks plus a [K, L] boolean observation
incidence matrix; covisibility queries are masked matrix-vector products.

Overflow policy as in JAX: writes beyond capacity are dropped and the
counters saturate.  JAX's `.at[...].set(mode="drop")` has no torch
counterpart, and selecting the kept entries (`torch.nonzero`) waits for
the device, so every write here is a scatter of the whole batch in which
a dropped entry writes back a value its destination already holds or is
given (`_append`, `_set_rows`): no host sync, and no two entries
write different values to one place.  The writes are `index_put_` and
out-of-place `index_fill`, which `torch.func.vmap` batches
(parallel/dp.py runs the tracker over a batch of arenas); it has no
batching rule for `index_copy_`.  Every `add_*` takes an optional 0-d
bool `enable` that gates its rows and its counter increments: the masked
form of the JAX tracker's `lax.cond` keyframe branch.

Unlike the functional JAX arena, the `add_*` functions update the arena's
tensors IN PLACE (they return the arena with new counters): the engine
holds one arena and never reads an old one, so no copy of the 8 MB of
incidence and descriptors is made per frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def _append(base: Tensor, keep: Tensor, n_rows: int, *writes) -> None:
    """Append a batch of entries at row `base`: for each (dst, src) of
    `writes`, the kept entries, in order, go to rows base, base + 1, ...
    of dst.  A dropped entry goes to a row of its own after them (mod
    n_rows) and writes back that row's value; with more entries than rows
    that cannot be, and `_set_rows` redirects the dropped ones instead."""
    k = keep.to(torch.int64)
    kept_before = torch.cumsum(k, 0) - k
    if k.shape[0] > n_rows:
        rows = torch.clamp(base + kept_before, max=n_rows - 1)
        for dst, src in writes:
            _set_rows(dst, rows, src, keep)
        return
    dropped_before = torch.arange(k.shape[0], device=k.device) - kept_before
    rows = torch.remainder(torch.where(
        keep, base + kept_before, base + torch.sum(k) + dropped_before),
        n_rows)
    for dst, src in writes:
        mask = keep.reshape(-1, *([1] * (src.dim() - 1)))
        dst.index_put_((rows,), torch.where(mask, src.to(dst.dtype),
                                            dst.index_select(0, rows)))


def _set_rows(dst: Tensor, rows: Tensor, src: Tensor, keep: Tensor) -> None:
    """dst[rows[i]] = src[i] where keep[i], for kept rows that are
    distinct but dropped entries that may share a row with them: a
    dropped entry writes the first kept entry's value to its row again,
    or row 0's own value to row 0 when nothing is kept."""
    src = src.to(dst.dtype)
    rows = rows.to(torch.int64)
    first = torch.argmax(keep.to(torch.int32)).reshape(1)    # 0 when none
    any_kept = torch.any(keep)
    zero = torch.zeros_like(first)
    row0 = rows.index_select(0, first) * any_kept
    val0 = torch.where(any_kept, src.index_select(0, first),
                       dst.index_select(0, zero))
    mask = keep.reshape(-1, *([1] * (src.dim() - 1)))
    dst.index_put_((torch.where(keep, rows, row0),),
                   torch.where(mask, src, val0))


def _enabled(mask: Tensor, enable) -> Tensor:
    return mask if enable is None else mask & enable


def add_keyframe(arena: MapArena, pose: Pose, time: Tensor,
                 enable: Optional[Tensor] = None) -> Tuple[MapArena, Tensor]:
    """Append a keyframe; returns (arena, slot) with slot == K when the
    pool is full (nothing is written then, nor when `enable` is False)."""
    K = arena.max_keyframes
    slot = arena.n_kf
    has_room = slot < K
    keep = _enabled(has_room, enable).reshape(1)
    _append(slot, keep, K, (arena.kf_q, pose.q[None]),
            (arena.kf_t, pose.t[None]), (arena.kf_time, time.reshape(1)),
            (arena.kf_valid, keep))
    step = torch.ones_like(slot) if enable is None else enable.to(slot.dtype)
    arena = arena._replace(n_kf=torch.clamp(arena.n_kf + step, max=K))
    return arena, torch.where(has_room, slot, torch.full_like(slot, K))


def add_landmarks(arena: MapArena, positions: Tensor, descs: Tensor,
                  valid: Tensor, enable: Optional[Tensor] = None
                  ) -> Tuple[MapArena, Tensor]:
    """Batch-insert landmarks [N]; returns (arena, slots [N]) with
    slot == L for dropped/invalid rows (all of them when disabled)."""
    L = arena.max_landmarks
    valid = _enabled(valid, enable)
    order = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    big = torch.full_like(order, L)
    slots = torch.where(valid, arena.n_lm + order, big)
    slots = torch.where(slots < L, slots, big)
    keep = slots < L
    _append(arena.n_lm, keep, L, (arena.lm_pos, positions),
            (arena.lm_desc, descs), (arena.lm_valid, keep))
    n_lm = torch.clamp(arena.n_lm + torch.sum(valid.to(torch.int32)), max=L)
    return arena._replace(n_lm=n_lm.to(torch.int32)), slots


def add_observations(arena: MapArena, kf_slot: Tensor, lm_slots: Tensor,
                     uv: Tensor, depth: Tensor, descs: Tensor,
                     valid: Tensor, enable: Optional[Tensor] = None
                     ) -> MapArena:
    """Record keyframe -> landmark observations: COO rows, incidence bits
    and the most-recent-descriptor refresh."""
    K, L = arena.max_keyframes, arena.max_landmarks
    O = arena.max_observations
    ok = _enabled(valid, enable) & (lm_slots < L) & (kf_slot < K)

    n_ok = torch.sum(ok.to(torch.int32))
    in_obs = ok & (arena.n_obs + torch.cumsum(ok.to(torch.int32), 0) <= O)
    _append(arena.n_obs, in_obs, O,
            (arena.obs_kf, kf_slot.to(torch.int32).expand(lm_slots.shape)),
            (arena.obs_lm, lm_slots), (arena.obs_uv, uv),
            (arena.obs_depth, depth), (arena.obs_valid, ok))
    # this keyframe's incidence row, rebuilt with the ok entries' bits (a
    # dropped keyframe has none: row K - 1 is written back unchanged)
    lm_idx = lm_slots.to(torch.int64)
    kf_row = torch.clamp(kf_slot.to(torch.int64), max=K - 1).reshape(1)
    hit = torch.zeros(L + 1, dtype=torch.bool, device=ok.device).index_fill(
        0, torch.where(ok, lm_idx, L), True)
    arena.inc.index_put_((kf_row,),
                         arena.inc.index_select(0, kf_row) | hit[None, :L])
    # the descriptor refresh: ok slots are distinct, the others may repeat
    # them
    _set_rows(arena.lm_desc, torch.clamp(lm_idx, max=L - 1), descs, ok)
    n_obs = torch.clamp(arena.n_obs + n_ok, max=O)
    return arena._replace(n_obs=n_obs.to(torch.int32))


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def covis_counts(arena: MapArena) -> Tensor:
    """[K, K] int32 shared-landmark counts (diagonal = own landmark
    count): one float32 product inc @ inc.T.  Exact: 0/1 products
    accumulate exactly in float32 up to 2^24 landmarks, and TF32 is off
    (see the package docstring)."""
    m = arena.inc.to(torch.float32)
    return torch.matmul(m, m.T).to(torch.int32)


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


def apply_backend_update(arena: MapArena, kf_q: Tensor, kf_t: Tensor,
                         lm_pos: Tensor, kf_mask: Tensor,
                         lm_mask: Tensor) -> MapArena:
    """Write BA-optimized poses/positions back where the masks are set
    (the reference's missing BasicMap::update(BackendOutput),
    basic_map.cpp:41-44 TODO).  Returns a new arena; the old one's
    tensors are not written."""
    return arena._replace(
        kf_q=torch.where(kf_mask[:, None], kf_q, arena.kf_q),
        kf_t=torch.where(kf_mask[:, None], kf_t, arena.kf_t),
        lm_pos=torch.where(lm_mask[:, None], lm_pos, arena.lm_pos),
    )
