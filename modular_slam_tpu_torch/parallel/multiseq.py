"""Multi-sequence batched SLAM, the BASELINE config 5 harness
(counterpart of modular_slam_tpu/parallel/multiseq.py).

Runs B independent sequences lock-step through the batched step
(parallel/dp.py): `chunk` frames of all B sequences per
`make_batch_slam_scan` call, each call's results fetched once, then
per-sequence trajectories and the scaling-efficiency metric
throughput(B sequences on N devices) / (N * throughput(1 sequence)).

The keys are JAX's: `PRNGKey(seed)` is split once per call, and the
subkey into one key per sequence and frame (`split(sub, C * B)`, [C, B]),
so that sequence b draws the triplets the JAX runner's sequence b draws.
A full chunk is one call; the frames left after the last full chunk go
one by one, as in JAX.
"""

from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import _resolve_device
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.io.tum import rgb_to_luma
from modular_slam_tpu_torch.parallel.dp import (make_batch_init,
                                                make_batch_slam_scan,
                                                row_groups)
from modular_slam_tpu_torch.parallel.mesh import make_mesh
from modular_slam_tpu_torch.utils.device import upload
from modular_slam_tpu_torch.utils.prng import prng_key, split
from modular_slam_tpu_torch.utils.profiling import span


class MultiSequenceRunner:
    """Lock-step batched odometry over B sequences (chunked dispatch).
    `mesh` defaults to a 1x1 grid of `device` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: SlamConfig, batch: int, mesh=None, seed: int = 0,
                 chunk: int = 8, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.chunk = chunk
        self.mesh = mesh or make_mesh(seq=1,
                                      devices=[_resolve_device(device)])
        self._groups = row_groups(self.mesh, batch)
        self._scan = make_batch_slam_scan(cfg, self.mesh)
        self.arenas, self.states = make_batch_init(cfg, self.mesh, batch)
        self._key = prng_key(seed)
        self._bootstrapped = False
        self.trajectories: List[List[Tuple[float, Pose]]] = [
            [] for _ in range(batch)]
        self.tracking_ok: List[List[bool]] = [[] for _ in range(batch)]

    def _upload(self, x) -> torch.Tensor:
        """Host array -> the first row's device, through pinned memory
        (the batched step moves each other row's part to its device)."""
        return upload(np.asarray(x), self._groups[0][0])

    def _bootstrap(self) -> bool:
        first = not self._bootstrapped
        self._bootstrapped = True
        return first

    def process_batch(self, grays, depths, times) -> None:
        """One frame of every sequence: grays/depths [B, H, W] float32;
        times [B].  A chunk of one frame: its keys `split(sub, 1 * B)` are
        JAX's `split(sub, B)`."""
        self.process_chunk(np.asarray(grays)[None], np.asarray(depths)[None],
                           np.asarray(times)[None])

    def process_chunk(self, grays, depths, times) -> None:
        """C frames of every sequence, queued without a host read:
        grays/depths [C, B, H, W] float32; times [C, B].  Spans (utils/
        profiling.py): `multiseq.chunk` around the call, `multiseq.upload`
        around the frames' uploads."""
        with span("multiseq.chunk"):
            times = np.asarray(times, np.float32)
            C = times.shape[0]
            self._key, sub = split(self._key)
            keys = split(sub, C * self.batch).reshape(C, self.batch, 2)
            with span("multiseq.upload"):
                frames = (self._upload(grays), self._upload(depths),
                          self._upload(times))
            self.arenas, self.states, results = self._scan(
                self.arenas, self.states, *frames, keys, self._bootstrap())
            self._collect(results, times, times.shape[0])

    def _collect(self, results, ts: np.ndarray, C: int) -> None:
        """Append [C, B] poses and tracking flags to the per-sequence
        lists: one host transfer per call.  The span `multiseq.collect`
        opens after the transfer, so that it holds the host's unpacking
        and not the wait for the card."""
        packed = torch.cat([
            results.pose.q.reshape(C, self.batch, 4),
            results.pose.t.reshape(C, self.batch, 3),
            results.tracking_ok.reshape(C, self.batch, 1).to(torch.float32),
        ], dim=-1).cpu().numpy()
        with span("multiseq.collect"):
            for i in range(C):
                for b in range(self.batch):
                    row = packed[i, b]
                    self.trajectories[b].append(
                        (float(ts[i, b]),
                         Pose(q=torch.from_numpy(row[:4].copy()),
                              t=torch.from_numpy(row[4:7].copy()))))
                    self.tracking_ok[b].append(bool(row[7]))

    def run(self, sequences: Sequence, max_frames: int | None = None) -> dict:
        """sequences: B iterables of (rgb, depth, ts).  Frames are staged
        on the host once (luma as `io.tum.rgb_to_luma` computes it), then
        dispatched `chunk` frames at a time; the frames after the last
        full chunk go one by one (`process_batch`)."""
        iters = [list(s) for s in sequences]
        n = min(len(s) for s in iters)
        if max_frames is not None:
            n = min(n, max_frames)
        grays = np.stack([
            np.stack([rgb_to_luma(torch.from_numpy(s[i][0])).numpy()
                      for s in iters]) for i in range(n)])   # [n, B, H, W]
        depths = np.stack([
            np.stack([np.asarray(s[i][1], np.float32) for s in iters])
            for i in range(n)])
        times = np.array([[s[i][2] for s in iters] for i in range(n)],
                         np.float32)                         # [n, B]

        t0 = time.perf_counter()
        lo = 0
        while lo + self.chunk <= n:
            hi = lo + self.chunk
            self.process_chunk(grays[lo:hi], depths[lo:hi], times[lo:hi])
            lo = hi
        for i in range(lo, n):
            self.process_batch(grays[i], depths[i], times[i])
        for dev, _ in self._groups:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        return {
            "frames_per_sequence": n,
            "total_frames": n * self.batch,
            "wall_s": dt,
            "frames_per_s": n * self.batch / dt,
        }


def scaling_efficiency(throughput_n: float, throughput_1: float,
                       n_devices: int) -> float:
    """BASELINE.md metric: throughput(N) / (N * throughput(1))."""
    return throughput_n / (n_devices * throughput_1)
