"""Arena lifecycle for long sequences: landmark culling, keyframe
eviction, slot compaction and duplicate-landmark fusion (counterpart of
modular_slam_tpu/map/lifecycle.py).

- `cull_landmarks`: invalidate landmarks with too few surviving
  observations, protecting the newest slots that are still being
  established;
- `evict_keyframes`: invalidate keyframes until at most `max_live` remain,
  redundant ones first (their landmarks seen by >= 3 other keyframes),
  then the oldest; the gauge keyframe and the newest ones are kept;
- `compact_arena`: squeeze valid keyframes, landmarks and observations to
  the front of their pools in order (slot order stays recency order) and
  reset the counters; returns the slot remaps for slot-aligned side
  structures (the loop database rows, the pose-graph edge endpoints);
- `fuse_duplicate_landmarks`: after a loop closure, merge the landmarks
  re-created on a revisit into their originals.

These run at the highwater mark or per loop closure, not per frame, and
return new tensors (the JAX versions are functional too); every
`.at[...].set(mode="drop")` is a write into a buffer with one spare row or
column that is cut off, never a clamped index.  The results equal the JAX
package's exactly: the keys are integers or exactly rounded float32, the
sorts are stable and the argmin/argmax take the first index.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.utils.indices import masked_indices

Tensor = torch.Tensor

# per-keyframe candidate cap of fusion (a keyframe observes at most
# max_keypoints landmarks)
_FUSE_CAP = 512


class SlotRemaps(NamedTuple):
    """Old-slot -> new-slot maps (== K/L for dropped slots)."""

    kf: Tensor   # [K+1] int32 (index K maps to K)
    lm: Tensor   # [L+1] int32


def landmark_obs_counts(arena: MapArena) -> Tensor:
    """[L] int32 — live observation count per landmark (from incidence)."""
    return torch.sum(arena.inc.to(torch.int32), dim=0, dtype=torch.int32)


def cull_landmarks(arena: MapArena, min_obs: int = 2,
                   protect_recent: int = 256) -> MapArena:
    """Invalidate landmarks with fewer than `min_obs` surviving
    observations, protecting the newest `protect_recent` slots — new
    landmarks legitimately start with a single observation."""
    L = arena.max_landmarks
    counts = landmark_obs_counts(arena)
    recent = torch.arange(L, device=counts.device) >= (arena.n_lm
                                                       - protect_recent)
    keep = arena.lm_valid & ((counts >= min_obs) | recent)
    dropped = arena.lm_valid & ~keep
    obs_valid = arena.obs_valid & ~dropped[arena.obs_lm.long()]
    return arena._replace(lm_valid=keep, obs_valid=obs_valid,
                          inc=arena.inc & keep[None, :])


def evict_keyframes(arena: MapArena, max_live: int, protect: int = 4,
                    redundancy: float = 0.9) -> MapArena:
    """Invalidate keyframes until at most `max_live` remain.  Victims:
    first keyframes with >= `redundancy` of their landmarks seen by >= 3
    other keyframes, then the oldest.  The oldest valid keyframe (the
    gauge) and the newest `protect` are never evicted; an evicted
    keyframe's observations and incidence row go with it."""
    K = arena.max_keyframes
    dev = arena.inc.device
    inc_i = arena.inc.to(torch.int32)
    observers = torch.sum(inc_i, dim=0, dtype=torch.int32)         # [L]
    own = torch.sum(inc_i, dim=1, dtype=torch.int32)               # [K]
    well_covered = (observers >= 4)[None, :] & arena.inc
    frac = (torch.sum(well_covered.to(torch.int32), dim=1,
                      dtype=torch.int32)
            / torch.clamp(own, min=1))                               # f32
    slots = torch.arange(K, device=dev)
    oldest_valid = torch.argmax(arena.kf_valid.to(torch.int32))    # first
    protect = min(protect, max(max_live - 1, 0))
    protected = ((slots == oldest_valid)
                 | (slots >= arena.n_kf - protect)
                 | ~arena.kf_valid)
    n_live = torch.sum(arena.kf_valid.to(torch.int32))
    n_evict = torch.clamp(n_live - max_live, min=0)

    # victim score: redundant first (a bonus of 10), then oldest
    age = 1.0 - slots.to(torch.float32) / K
    score = torch.where(frac >= redundancy, 10.0 + frac,
                        torch.zeros_like(frac)) + age
    score = torch.where(protected, torch.full_like(score, -1.0), score)
    order = torch.argsort(-score, stable=True)              # best victims
    rank = torch.empty(K, dtype=torch.int64, device=dev)
    rank[order] = slots
    evict = (score > 0) & (rank < n_evict)

    kf_valid = arena.kf_valid & ~evict
    obs_valid = arena.obs_valid & ~evict[arena.obs_kf.long()]
    return arena._replace(kf_valid=kf_valid, obs_valid=obs_valid,
                          inc=arena.inc & kf_valid[:, None])


def _scatter_true(rows: Tensor, cols: Tensor, K: int, L: int) -> Tensor:
    """[K, L] bool with True at (rows, cols); pairs with row K or col L
    land in the spare row/column, which is cut off."""
    out = torch.zeros((K + 1, L + 1), dtype=torch.bool, device=rows.device)
    out.view(-1).index_fill_(0, rows.long() * (L + 1) + cols.long(), True)
    return out[:K, :L]


def _new_slots(keep: Tensor, n: int) -> Tensor:
    """[n + 1] int32 old -> new slot (n for dropped slots and for n)."""
    new = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0,
                                         dtype=torch.int32) - 1, n)
    return torch.cat([new.to(torch.int32),
                      torch.full((1,), n, dtype=torch.int32,
                                 device=keep.device)])


def compact_arena(arena: MapArena) -> Tuple[MapArena, SlotRemaps]:
    """Squeeze valid entries to the front of every pool (order-preserving)
    and reset the counters, so the freed tail accepts new insertions.
    Returns remaps for slot-aligned side structures."""
    K, L, O = (arena.max_keyframes, arena.max_landmarks,
               arena.max_observations)
    kf_keep = arena.kf_valid
    lm_keep = arena.lm_valid
    obs_kf, obs_lm = arena.obs_kf.long(), arena.obs_lm.long()
    obs_keep = arena.obs_valid & kf_keep[obs_kf] & lm_keep[obs_lm]

    kf_map = _new_slots(kf_keep, K)
    lm_map = _new_slots(lm_keep, L)

    def count(m):
        return torch.sum(m.to(torch.int32), dtype=torch.int32)

    # old slot of each new slot, in order
    kf_old = masked_indices(kf_keep, K)
    lm_old = masked_indices(lm_keep, L)
    obs_old = masked_indices(obs_keep, O)
    kf_g = torch.clamp(kf_old, 0, K - 1)
    lm_g = torch.clamp(lm_old, 0, L - 1)
    obs_g = torch.clamp(obs_old, 0, O - 1)
    kf_ok, lm_ok, obs_ok = kf_old < K, lm_old < L, obs_old < O

    new_obs_kf = kf_map[obs_kf[obs_g]]
    new_obs_lm = lm_map[obs_lm[obs_g]]
    inc = _scatter_true(torch.where(obs_ok, new_obs_kf, K),
                        torch.where(obs_ok, new_obs_lm, L), K, L)

    ident_q = torch.zeros((K, 4), dtype=torch.float32, device=kf_g.device)
    ident_q[:, 0] = 1.0
    zero_i = torch.zeros_like(new_obs_kf)
    arena = MapArena(
        kf_q=torch.where(kf_ok[:, None], arena.kf_q[kf_g], ident_q),
        kf_t=torch.where(kf_ok[:, None], arena.kf_t[kf_g], 0.0),
        kf_time=torch.where(kf_ok, arena.kf_time[kf_g], 0.0),
        kf_valid=kf_ok,
        lm_pos=torch.where(lm_ok[:, None], arena.lm_pos[lm_g], 0.0),
        lm_desc=torch.where(lm_ok[:, None], arena.lm_desc[lm_g],
                            torch.zeros_like(arena.lm_desc[:1])),
        lm_valid=lm_ok,
        inc=inc,
        obs_kf=torch.where(obs_ok, new_obs_kf, zero_i),
        obs_lm=torch.where(obs_ok, new_obs_lm, zero_i),
        obs_uv=torch.where(obs_ok[:, None], arena.obs_uv[obs_g], 0.0),
        obs_depth=torch.where(obs_ok, arena.obs_depth[obs_g], 0.0),
        obs_valid=obs_ok,
        n_kf=count(kf_keep), n_lm=count(lm_keep), n_obs=count(obs_keep))
    return arena, SlotRemaps(kf=kf_map, lm=lm_map)


def fuse_duplicate_landmarks(
    arena: MapArena,
    kf_a: int,              # current keyframe slot
    kf_b: int,              # matched loop keyframe slot
    max_dist: float = 0.10,
    max_hamming: int = 40,
) -> Tuple[MapArena, Tensor]:
    """Merge landmarks re-created on a revisit: each landmark of kf_a not
    shared with kf_b is matched to its best kf_b landmark; a mutual-best
    pair within `max_hamming` bits and `max_dist` meters, with no third
    keyframe observing both, redirects kf_a's landmark's observations to
    the kf_b landmark and invalidates the duplicate.  -> (arena, n_fused).
    Run after pose-graph correction / global BA, so positions share a
    frame.  Candidates are capped at 512 per keyframe, so the pairwise
    matrices are [512, 512], never [L, L]."""
    L = arena.max_landmarks
    K = arena.max_keyframes
    cap = _FUSE_CAP
    in_a = arena.inc[kf_a] & arena.lm_valid                        # [L]
    in_b = arena.inc[kf_b] & arena.lm_valid
    # landmarks seen by BOTH are already shared — exclude
    both = in_a & in_b
    in_a = in_a & ~both
    in_b = in_b & ~both

    a_idx = masked_indices(in_a, cap)
    b_idx = masked_indices(in_b, cap)
    a_ok, b_ok = a_idx < L, b_idx < L
    a_g = torch.clamp(a_idx, 0, L - 1)
    b_g = torch.clamp(b_idx, 0, L - 1)

    # pairwise Hamming via the ±1 dot product (exact in float32)
    desc_a = arena.lm_desc[a_g].to(torch.float32)                  # [A, D]
    desc_b = arena.lm_desc[b_g].to(torch.float32)
    ham = (desc_a.shape[1] - desc_a @ desc_b.T) * 0.5              # [A, B]
    diff = arena.lm_pos[a_g][:, None, :] - arena.lm_pos[b_g][None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)

    okpair = (a_ok[:, None] & b_ok[None, :]
              & (ham <= max_hamming) & (d2 <= max_dist ** 2))
    # a THIRD keyframe observing both the source and the target would hold
    # two observations of the fused landmark: exclude such pairs
    inc_f = arena.inc.to(torch.float32)                            # [K, L]
    shared_observer = inc_f[:, a_g].T @ inc_f[:, b_g]              # [A, B]
    okpair = okpair & (shared_observer == 0)
    score = torch.where(okpair, ham + 1e-3 * torch.sqrt(d2),
                        torch.full_like(ham, float("inf")))
    best = torch.argmin(score, dim=1)                              # a -> b
    # injectivity: a target is claimed only by its best source
    best_src = torch.argmin(score, dim=0)                          # b -> a
    mutual = best_src[best] == torch.arange(cap, device=best.device)
    fuse = torch.isfinite(torch.amin(score, dim=1)) & mutual       # [A]
    target = b_g[best]

    src = torch.where(fuse, a_idx, L)
    canon = torch.arange(L + 1, dtype=torch.int32, device=src.device)
    canon[src] = torch.where(fuse, target, 0).to(torch.int32)
    obs_lm = canon[:L][torch.clamp(arena.obs_lm.long(), 0, L - 1)]
    cleared = torch.zeros(L + 1, dtype=torch.bool, device=src.device)
    cleared.index_fill_(0, src, True)
    lm_valid = arena.lm_valid & ~cleared[:L]
    # rebuild the incidence under the remap
    inc = _scatter_true(torch.where(arena.obs_valid, arena.obs_kf.long(), K),
                        torch.where(arena.obs_valid, obs_lm.long(), L), K, L)
    arena = arena._replace(obs_lm=obs_lm, lm_valid=lm_valid,
                           inc=inc & lm_valid[None, :])
    return arena, torch.sum(fuse.to(torch.int32), dtype=torch.int32)
