"""Carry engine state between the JAX package and the port.

The system has no learned weights: its state is the `MapArena`, the
`TrackState`, the frame's `Features` and, with loop closure, the
`LoopDatabase` and the `PoseGraphEdges`.  The `*_from_numpy` functions
take the JAX package's NamedTuples with numpy leaves (for example
`jax.tree.map(np.asarray, arena)`) — or anything with the same field
names — and build the port's tensors on `device`; the `*_to_numpy`
functions return nested dicts of numpy arrays with the JAX field names
and dtypes, from which the JAX NamedTuples are rebuilt with `**`.

`Descriptors.packed` is uint32 in JAX and int32 here, with the same bits.
A PRNG key is a uint32[2] numpy array in both (`key_from_numpy`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from modular_slam_tpu_torch.backend.posegraph import PoseGraphEdges
from modular_slam_tpu_torch.frontend.tracker import TrackState
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.loop.detector import LoopDatabase
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.types import Descriptors, Features, Keypoints
from modular_slam_tpu_torch.utils.prng import as_key


def _t(x, device) -> torch.Tensor:
    """A copy: the port updates the arena in place, and a JAX array's
    numpy view is read-only."""
    a = np.array(x, copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device)


def _n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _fields(obj, names):
    return {k: getattr(obj, k) for k in names}


def arena_from_numpy(arena: Any, device="cpu") -> MapArena:
    return MapArena(**{k: _t(v, device) for k, v in
                       _fields(arena, MapArena._fields).items()})


def arena_to_numpy(arena: MapArena) -> Dict[str, np.ndarray]:
    return {k: _n(getattr(arena, k)) for k in MapArena._fields}


def pose_from_numpy(pose: Any, device="cpu") -> Pose:
    return Pose(q=_t(pose.q, device), t=_t(pose.t, device))


def pose_to_numpy(pose: Pose) -> Dict[str, np.ndarray]:
    return {"q": _n(pose.q), "t": _n(pose.t)}


def key_from_numpy(key: Any) -> np.ndarray:
    """A JAX PRNG key (`jax.random.PRNGKey`'s uint32[2], its numpy array
    or an int32 view of it) as the port's key (utils/prng.py), a copy."""
    return as_key(key).reshape(2).copy()


def track_state_from_numpy(state: Any, device="cpu") -> TrackState:
    return TrackState(
        pose=pose_from_numpy(state.pose, device),
        ref_kf=_t(state.ref_kf, device), frame_idx=_t(state.frame_idx, device),
        lost=_t(state.lost, device), since_kf=_t(state.since_kf, device))


def track_state_to_numpy(state: TrackState) -> Dict[str, Any]:
    out = {k: _n(getattr(state, k)) for k in TrackState._fields
           if k != "pose"}
    out["pose"] = pose_to_numpy(state.pose)
    return out


def features_from_numpy(feats: Any, device="cpu") -> Features:
    kps = Keypoints(**{k: _t(v, device) for k, v in
                       _fields(feats.keypoints, Keypoints._fields).items()})
    desc = Descriptors(packed=_t(feats.descriptors.packed, device),
                       unpacked=_t(feats.descriptors.unpacked, device))
    return Features(keypoints=kps, descriptors=desc)


def features_to_numpy(feats: Features) -> Dict[str, Dict[str, np.ndarray]]:
    kps = {k: _n(getattr(feats.keypoints, k)) for k in Keypoints._fields}
    packed = _n(feats.descriptors.packed).view(np.uint32)
    return {"keypoints": kps,
            "descriptors": {"packed": packed,
                            "unpacked": _n(feats.descriptors.unpacked)}}


def loop_database_from_numpy(db: Any, device="cpu") -> LoopDatabase:
    return LoopDatabase(**{k: _t(v, device) for k, v in
                           _fields(db, LoopDatabase._fields).items()})


def loop_database_to_numpy(db: LoopDatabase) -> Dict[str, np.ndarray]:
    return {k: _n(getattr(db, k)) for k in LoopDatabase._fields}


def pose_graph_edges_from_numpy(edges: Any, device="cpu") -> PoseGraphEdges:
    return PoseGraphEdges(**{k: _t(v, device) for k, v in
                             _fields(edges, PoseGraphEdges._fields).items()})


def pose_graph_edges_to_numpy(edges: PoseGraphEdges) -> Dict[str, np.ndarray]:
    return {k: _n(getattr(edges, k)) for k in PoseGraphEdges._fields}
