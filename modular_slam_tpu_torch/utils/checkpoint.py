"""Checkpoint and resume of a `SlamSystem` (counterpart of
modular_slam_tpu/utils/checkpoint.py).

One `.npz` with the JAX package's keys: the map arena (`arena.*`), the
tracking state (`state.*`), the loop database (`loopdb.*`), the pose-graph
edges (`edges.*`), the loop counters and closure-cooldown state
(`loop.*`), the BoW codebook (`loop.vocab`), the engine counters
(`counters`), the runtime parameters (`params_json`), the trajectory
(`trajectory`, rows t x y z qw qx qy qz), the PRNG key (`key`, uint32[2])
and an echo of the config (`config_json`).  The port loads the JAX
package's checkpoints and the JAX package loads the port's; either
resumes on the saved key, so the resumed run draws what the saving
engine would have drawn next.

A file the port wrote before it carried JAX's key (it has a
`sampler_state`, the state of the sampler that stood in for the key then,
and no `key`) still loads: the system keeps the key of its own seed, and
`sampler_state` is ignored.  An injected sampler is neither saved nor
restored.

Tensors load onto `system.device`, so a checkpoint written on the card
loads into a CPU system and the other way round.
"""

from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace
from typing import Any, Dict

import numpy as np
import torch

from modular_slam_tpu_torch.backend.posegraph import PoseGraphEdges
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.loop.detector import LoopDatabase
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.utils import state as conv


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]) -> None:
    if hasattr(tree, "_fields"):  # NamedTuple
        for name in tree._fields:
            _flatten(f"{prefix}{name}.", getattr(tree, name), out)
    else:
        out[prefix.rstrip(".")] = _host(tree)


def _host(x) -> np.ndarray:
    return torch.as_tensor(x).detach().cpu().numpy()


def _section(data, prefix: str, fields) -> SimpleNamespace:
    return SimpleNamespace(**{f: data[prefix + f] for f in fields})


def _json(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_checkpoint(path: str, system) -> None:
    """Serialize a SlamSystem to `path` (.npz).  Finishes its pending work
    first (`flush_backend`: a deferred chunk, an async BA window, queued
    closures and a queued global-BA polish)."""
    system.flush_backend()
    out: Dict[str, np.ndarray] = {}
    _flatten("arena.", system.arena, out)
    _flatten("state.", system.state, out)
    out["key"] = np.asarray(system._key, np.uint32)
    lp = system._loop
    if lp is not None:
        _flatten("loopdb.", lp.db, out)
        _flatten("edges.", lp.edges, out)
        out["loop.n_edges"] = np.int64(lp._n_edges)
        out["loop.prev_kf"] = np.int64(
            -1 if lp._prev_kf is None else lp._prev_kf)
        out["loop.n_global_ba"] = np.int64(lp.n_global_ba)
        # closure-cooldown state: a resumed run must not fire a closure
        # the cooldown was suppressing
        out["loop.kf_counter"] = np.int64(lp._kf_counter)
        out["loop.last_closure_at"] = np.int64(lp._last_closure_at)
        # the database histograms mean something only against the
        # codebook that made them
        out["loop.vocab"] = lp._vocab.cpu().numpy().astype(np.int8)
    out["counters"] = np.array([system.n_loop_closures,
                                system.n_relocalizations,
                                system._kf_since_ba], np.int64)
    out["params_json"] = _json({k: system.params.get(k)
                                for k in system.params.names()})
    out["trajectory"] = np.array(
        [[t, *_host(p.t), *_host(p.q)] for t, p in system.trajectory],
        dtype=np.float64).reshape(-1, 8)
    out["config_json"] = _json(dataclasses.asdict(system.cfg))
    np.savez_compressed(path, **out)


def load_checkpoint(path: str, system) -> None:
    """Restore a checkpoint into a SlamSystem built with the same
    capacities (a ValueError names the first pool that differs).  The
    system's pending work is dropped: its scan is rebuilt, its backend
    reopened, and whether the map is empty is read again at the next
    frame."""
    with np.load(path) as data:
        _restore(data, system)


def _restore(data, system) -> None:
    dev = system.device
    arena = _section(data, "arena.", MapArena._fields)
    for name in MapArena._fields:
        have = tuple(getattr(system.arena, name).shape)
        got = tuple(getattr(arena, name).shape)
        if got != have:
            raise ValueError(f"checkpoint capacity mismatch: arena.{name} "
                             f"{got} vs {have}")
    # the system's own pending work belongs to the map being replaced
    system._pending_chunk = None
    if system._backend is not None:
        system._backend.close()
        system._backend = None
    system.arena = conv.arena_from_numpy(arena, dev)
    st = {f: data["state." + f] for f in ("ref_kf", "frame_idx", "lost")}
    st["since_kf"] = (data["state.since_kf"] if "state.since_kf" in data
                      else np.int32(0))
    system.state = conv.track_state_from_numpy(SimpleNamespace(
        pose=_section(data, "state.pose.", ("q", "t")), **st), dev)
    # the map may hold keyframes: read at the next frame, not assumed
    system._has_map = None
    system._scan = None
    system._scan_takes_db = False
    system._prev_counters = None
    system._chunk_growth = (0, 0, 0)
    if "key" in data:
        system._key = conv.key_from_numpy(data["key"])
    lp = system._loop
    if lp is not None and "loopdb.hists" in data:
        if "loop.vocab" in data:
            saved = np.asarray(data["loop.vocab"], np.int8)
            if not np.array_equal(saved, lp._vocab.cpu().numpy()):
                lp.set_vocab(saved)
        lp.db = conv.loop_database_from_numpy(
            _section(data, "loopdb.", LoopDatabase._fields), dev)
        lp.edges = conv.pose_graph_edges_from_numpy(
            _section(data, "edges.", PoseGraphEdges._fields), dev)
        lp._n_edges = int(data["loop.n_edges"])
        pk = int(data["loop.prev_kf"])
        lp._prev_kf = None if pk < 0 else pk
        lp._pending_verify = []
        lp._gba_pending = False
        if "loop.n_global_ba" in data:
            lp.n_global_ba = int(data["loop.n_global_ba"])
        if "loop.kf_counter" in data:
            lp._kf_counter = int(data["loop.kf_counter"])
            lp._last_closure_at = int(data["loop.last_closure_at"])
    if "counters" in data:
        c = data["counters"]
        system.n_loop_closures = int(c[0])
        system.n_relocalizations = int(c[1])
        system._kf_since_ba = int(c[2])
    if "params_json" in data:
        vals = json.loads(bytes(data["params_json"]).decode())
        for k, v in vals.items():
            if k in system.params.names() and system.params.get(k) != v:
                system.params.set(k, v)   # re-tunes and rebuilds the step
    system.trajectory = [
        (float(r[0]), Pose(q=torch.tensor(r[4:8], dtype=torch.float32),
                           t=torch.tensor(r[1:4], dtype=torch.float32)))
        for r in data["trajectory"]]
