"""Relocalization after tracking loss (counterpart of
modular_slam_tpu/loop/relocalizer.py): BoW query over the keyframe
database, geometric verification of the best candidates, recovered pose.

The JAX relocalizer verifies its candidates one by one in a `lax.scan`
and keeps the first that verifies with a positive score.  Here the batched
`geometric_verify` verifies all of them at once (one K2 launch) and the
same first one is picked on the device, with no host read.  The scan's
keys — `key, sub = split(key)` before each candidate — are split on the
host in the candidates' order (`candidate_keys`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import camera_from_config
from modular_slam_tpu_torch.geometry.se3 import Pose, identity_pose
from modular_slam_tpu_torch.loop.detector import (LoopDatabase,
                                                  geometric_verify,
                                                  query_candidates)
from modular_slam_tpu_torch.loop.vocab import (bow_histogram,
                                               load_trained_vocab)
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.types import Features
from modular_slam_tpu_torch.utils.prng import Uniforms, split

Tensor = torch.Tensor


def _pick(x: Tensor, i: Tensor) -> Tensor:
    """x[i] for a 0-d index tensor, gathered on the device (indexing with
    a 0-d tensor reads it back to the host)."""
    return x.index_select(0, i.reshape(1))[0]


def candidate_keys(key, n: int):
    """The keys of the relocalizer's `n` candidates, [..., n, 2] from
    keys [..., 2]: `key, sub = split(key)` before each candidate, in
    order (the JAX relocalizer's scan).  A sampler standing in for the
    key is given back."""
    if callable(key):
        return key
    subs = []
    for _ in range(n):
        pair = split(key)
        key = pair[..., 0, :]
        subs.append(pair[..., 1, :])
    return np.stack(subs, axis=-2)


def make_relocalizer(cfg: SlamConfig, vocab: Optional[Tensor] = None, *,
                     device=None) -> Callable:
    """Returns fn(arena, db, feats, key) -> (ok, pose, kf_slot,
    n_inliers), all 0-d tensors (and a Pose) on the vocab's device: the
    first of the top-k BoW candidates that verifies geometrically, or
    (False, identity, -1, 0).  `key` is a PRNG key [2], the `Uniforms`
    of the candidates' keys ([top_k, n_hyp, 3]), or a sampler.

    `vocab` [V, 256] ±1 int8 overrides the packaged codebook
    (`load_trained_vocab(cfg.loop.vocab_size)`), and MUST be the codebook
    the database histograms were built with.  With no `vocab` the packaged
    one is loaded onto `device` (default "cuda"; RuntimeError without a
    CUDA device); a given `vocab` keeps its device, which `device`, if
    given, must name.  The fn carries its codebook as `fn.vocab`."""
    from modular_slam_tpu_torch.engine import _resolve_device

    if vocab is None:
        vocab = torch.as_tensor(
            load_trained_vocab(cfg.loop.vocab_size),
            device=_resolve_device("cuda" if device is None else device))
    elif device is not None:
        dev = _resolve_device(device)
        if dev.type != vocab.device.type or dev.index not in (
                None, vocab.device.index):
            raise ValueError(f"vocab on {vocab.device} but "
                             f"device={device!r}")
    cam = camera_from_config(cfg.camera, vocab.device)

    def relocalize(arena: MapArena, db: LoopDatabase, feats: Features,
                   key) -> Tuple[Tensor, Pose, Tensor, Tensor]:
        hist = bow_histogram(feats.descriptors.unpacked,
                             feats.keypoints.valid, vocab)
        # no temporal mask for relocalization: any keyframe may rescue us
        scores, slots = query_candidates(db, hist, -10_000, min_gap=0,
                                         top_k=cfg.loop.top_k)
        if not isinstance(key, Uniforms):
            key = candidate_keys(key, slots.shape[0])
        ok, n_inl, pose = geometric_verify(arena, slots, feats, cam, cfg,
                                           key)
        use = ok & (scores > 0.0)
        first = torch.argmax(use.to(torch.int32))      # 0 when none is
        found = torch.any(use)
        none = identity_pose(device=vocab.device)
        q = torch.where(found, _pick(pose.q, first), none.q)
        t = torch.where(found, _pick(pose.t, first), none.t)
        slot = torch.where(found, _pick(slots, first).to(torch.int32),
                           torch.full((), -1, dtype=torch.int32,
                                      device=vocab.device))
        n = torch.where(found, _pick(n_inl, first),
                        torch.zeros_like(n_inl[0]))
        return found, Pose(q=q, t=t), slot, n

    relocalize.vocab = vocab
    return relocalize
