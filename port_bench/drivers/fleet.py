"""The fleet traffic: B sequences tracked in lock-step through the port's
`parallel/multiseq.py::MultiSequenceRunner.process_chunk`.

Each sequence has its own room (the box room of `scene.py`, drawn from
the seed) and its own closed sweep at the configuration's speed and rate
(`scene.sweep_path`).  A bank of `bank_frames` frames per sequence, one
period of the sweep, is rendered on the card in set-up and held on the
host once; playback runs round the period, and every chunk is one
contiguous slice of the bank.  The loop is closed: the next chunk goes
once `process_chunk` has collected the previous chunk's results.
Timestamps are the frame index at the sensor rate, the same in every
sequence.

The output check, after the window.  `check_chunks` more chunks go
through the same call on the same runner; before each, the map of
`check_sequences` sequences drawn from the seed is copied (landmark
descriptors, positions and flags, incidence, keyframe flags, counters,
the reference keyframe).  For each of those sequences, the first
keyframe that a check chunk inserts was matched against exactly that
map, and is judged:

- `match_gap_pct`: the observations the port inserted for that keyframe
  against the ones the plain step gives (`reference/match.py`): the plain
  detector's keypoints matched by a plain Hamming 2-NN with the ratio
  test and duplicate removal against the copied map's landmarks that the
  reference keyframe's 2-hop covisibility selects; a match is inserted
  where it passes the PnP gates at the port's pose, a keypoint without a
  match becomes a new landmark where its depth is near enough.  Each
  observation is (pixel, landmark), a new landmark's landmark being
  "new"; the number is the share of the union that one side lacks (the
  detector, K1, K2 and its merge, duplicate removal, RANSAC's inliers,
  the arena's inserts);
- `kf_pose_gap_mm`: the largest distance between where the port's pose
  of that keyframe and the plain fit put the camera centre and the
  corners of the view at 2 m.  The fit (`reference/track.py`, float64)
  is the Gauss-Newton optimum of the configuration's hybrid residual on
  the plain step's matches above, from the exact pose.  Keyframes at
  whose optimum one of those matches leaves the gates are left out:
  there the port may keep its RANSAC hypothesis, as its PnP does when a
  polish loses inliers (counted in `info.keyframes_off_the_optimum_rule`);
- `kp_miss_pct`: of the observations of the last keyframe of
  `keypoint_sequences` sequences drawn from the seed, the share whose
  pixel, depth and descriptor (the landmark's, which its last
  observation sets) are not a keypoint of the plain detector
  (`reference/detector.py`) in that frame;
- `frames_not_tracked`: frames of the window and the check chunks that
  the port did not track; the configuration states that every frame is.

Where the landmarks a keyframe was matched against cannot be known (its
sequence's keyframes do not all select the same landmarks, and the
reference keyframe may have moved since the chunk began), the keyframe
is left out and counted (`info.keyframes_ambiguous`).  The match and pose
numbers are infinite where a sequence inserted no keyframe in the window
and the check chunks (the tracker inserts one at least every 30 frames)
or where no keyframe was judged.  The references follow the port from
the port's own map (its landmark positions and descriptors); the start,
the keypoints, is checked on its own above.
"""

from __future__ import annotations

import math
import os
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from port_bench import peaks, scene
from port_bench.reference import detector as ref_det
from port_bench.reference import match as ref_match
from port_bench.reference import track as ref_track

SNAPSHOT = ("lm_desc", "lm_valid", "lm_pos", "inc", "kf_valid", "n_lm", "n_kf")


def slam_config(cfg: dict):
    """The port's SlamConfig with the configuration file's settings."""
    from modular_slam_tpu_torch.config import (CameraConfig, DetectorConfig,
                                               MapConfig, MatcherConfig,
                                               PnpConfig, SlamConfig,
                                               TrackerConfig)

    s, sen = cfg["slam"], cfg["sensor"]
    return SlamConfig(
        camera=CameraConfig(fx=sen["fx"], fy=sen["fy"], cx=sen["cx"],
                            cy=sen["cy"], depth_factor=1.0 / sen["depth_factor"],
                            width=sen["width"], height=sen["height"]),
        detector=DetectorConfig(n_levels=s["n_levels"],
                                scale_factor=s["scale_factor"],
                                max_keypoints=s["max_keypoints"]),
        matcher=MatcherConfig(**s["matcher"]),
        pnp=PnpConfig(**s["pnp"]),
        tracker=TrackerConfig(**s["tracker"]),
        map=MapConfig(max_keyframes=s["max_keyframes"],
                      max_landmarks=s["max_landmarks"],
                      max_observations=s["max_observations"]))


def _camera(cfg: dict) -> scene.Camera:
    s = cfg["sensor"]
    return scene.Camera(s["fx"], s["fy"], s["cx"], s["cy"], s["width"],
                        s["height"])


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.B = int(traffic["batch"])
        self.chunk = int(traffic["chunk"])
        self.bank = int(traffic["bank_frames"])
        self.rate = float(cfg["sensor"]["rate_hz"])
        self.cam = _camera(cfg)
        self.next_frame = 0
        self.window_frames = (0, 0)

    # -- set-up -----------------------------------------------------------
    def _render(self) -> None:
        """Bank [bank, B, H, W] of luma and depth on the host, one period
        of each sequence's sweep, and each sequence's exact path."""
        c, m = self.cam, self.cfg["motion"]
        P = self.bank
        self.gray = np.empty((P, self.B, c.height, c.width), np.float32)
        self.depth = np.empty_like(self.gray)
        # fault the bank's pages in on every core at once: first-touch page
        # faults in one thread dominated set-up (~1 GB/s)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
            list(ex.map(lambda a: a.fill(0.0),
                        [x[i] for x in (self.gray, self.depth) for i in range(P)]))
        self.prefault_s = time.perf_counter() - t0
        self.paths = []
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.default_rng([self.seed]).integers(0, 2 ** 62)))
        # one texture; each room's surfaces take their own windows of it
        tex = scene.make_texture(gen, scene.TEXTURE_SIZE, self.device)
        cuda = self.device.type == "cuda"
        # two pinned stages: the card renders one sequence while threads
        # copy the previous one into the bank
        stages = [torch.empty((2, P, c.height, c.width), dtype=torch.float32,
                              pin_memory=cuda) for _ in range(2)]
        pending = [[], []]
        with ThreadPoolExecutor(4) as ex:
            for b in range(self.B):
                rng = np.random.default_rng([self.seed, b])
                rects = scene.room_rects(rng, int(self.cfg["scene"]["n_boxes"]),
                                         scene.TEXTURE_SIZE)
                R, t = scene.sweep_path(rng, P, m["speed_m_s"], m["rot_deg_s"],
                                        self.rate)
                self.paths.append((R, t))
                g, d = scene.render(c, rects, tex,
                                    torch.as_tensor(R, device=self.device),
                                    torch.as_tensor(t, device=self.device))
                d = scene.kinect_depth(d, gen)
                st = stages[b % 2]
                for f in pending[b % 2]:
                    f.result()
                st[0].copy_(g, non_blocking=cuda)
                st[1].copy_(d, non_blocking=cuda)
                done = torch.cuda.Event() if cuda else None
                if cuda:
                    done.record()

                def put(dst, src, done=done, b=b):
                    if done is not None:
                        done.synchronize()
                    dst[:, b] = src.numpy()
                pending[b % 2] = [ex.submit(put, self.gray, st[0]),
                                  ex.submit(put, self.depth, st[1])]
            for f in pending[0] + pending[1]:
                f.result()
        del tex, stages

    def _chunk(self):
        n0 = self.next_frame
        lo = n0 % self.bank
        times = (np.arange(n0, n0 + self.chunk, dtype=np.float64) / self.rate)
        times = np.repeat(times[:, None], self.B, 1).astype(np.float32)
        self.next_frame += self.chunk
        return (self.gray[lo:lo + self.chunk], self.depth[lo:lo + self.chunk],
                times)

    def setup(self) -> None:
        from modular_slam_tpu_torch.parallel.multiseq import MultiSequenceRunner

        if self.bank % self.chunk:
            raise ValueError("the bank must hold whole chunks")
        t0 = time.perf_counter()
        self._render()
        self.setup_phases = {"bank_s": time.perf_counter() - t0}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(self.device)
        self.runner = MultiSequenceRunner(slam_config(self.cfg), self.B,
                                          seed=self.seed % 2 ** 63,
                                          chunk=self.chunk, device=self.device)
        t1 = time.perf_counter()
        for _ in range(int(self.traffic["warmup_chunks"])):
            self.runner.process_chunk(*self._chunk())
        torch.cuda.synchronize(self.device)
        self.setup_phases["runner_and_warmup_s"] = time.perf_counter() - t1

    # -- the window -------------------------------------------------------
    def _untracked(self, lo: int, hi: int) -> int:
        return sum(hi - lo - sum(f[lo:hi]) for f in self.runner.tracking_ok)

    def window(self, seconds: float) -> Dict[str, float]:
        first = self.next_frame
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.runner.process_chunk(*self._chunk())
        elapsed = time.perf_counter() - t0
        self.window_frames = (first, self.next_frame)
        done = (self.next_frame - first) * self.B
        self.attempted = done
        self.failed = self._untracked(first, self.next_frame)
        return {"seq_frames_per_s": done / elapsed}

    def traced_work(self):
        """(run, units) for the traced window: `trace_chunks` chunks."""
        n = int(self.traffic["trace_chunks"])

        def run():
            for _ in range(n):
                self.runner.process_chunk(*self._chunk())
        return run, n * self.chunk

    def shapes(self) -> dict:
        s = self.cfg["slam"]
        return {"batch": self.B,
                "levels": peaks.pyramid_shapes(self.cam.height, self.cam.width,
                                               s["n_levels"], s["scale_factor"]),
                "n_query": s["max_keypoints"], "n_train": s["max_landmarks"]}

    # -- the output check -------------------------------------------------
    def collect(self) -> None:
        """Run the check chunks, each after a copy of the judged
        sequences' maps; copy what is judged to the host and free the
        port's state."""
        r = self.runner
        rng = np.random.default_rng([self.seed, 11])
        n_seq = min(self.B, int(self.traffic["check_sequences"]))
        self.check_seqs = np.sort(rng.choice(self.B, n_seq, replace=False))
        sel = torch.as_tensor(self.check_seqs, device=self.device)
        self.snaps = []
        lo = self.next_frame
        for _ in range(int(self.traffic["check_chunks"])):
            a = r.arenas[0]
            snap = {k: getattr(a, k).index_select(0, sel) for k in SNAPSHOT}
            snap["ref_kf"] = r.states[0].ref_kf.index_select(0, sel)
            self.snaps.append((self.next_frame, snap))
            r.process_chunk(*self._chunk())
        self.check_frames = (lo, self.next_frame)
        self.check_failed = self._untracked(lo, self.next_frame)
        a = r.arenas[0]
        n_obs = int(a.n_obs.max())
        host = {k: getattr(a, k).cpu() for k in ("kf_q", "kf_t", "kf_time",
                                                  "kf_valid", "n_kf", "lm_pos",
                                                  "lm_desc", "lm_valid")}
        for k in ("obs_kf", "obs_lm", "obs_uv", "obs_depth", "obs_valid"):
            host[k] = getattr(a, k)[:, :n_obs].cpu()
        self.arena = host
        self.traj = [list(tr) for tr in r.trajectories]
        del self.runner, r
        torch.cuda.empty_cache()

    def _frame_of(self, t: float) -> int:
        return int(round(t * self.rate))

    def _settings(self) -> ref_det.DetectorSettings:
        s = self.cfg["slam"]
        return ref_det.DetectorSettings(n_levels=s["n_levels"],
                                        scale_factor=s["scale_factor"],
                                        max_keypoints=s["max_keypoints"])

    def sequences_with_a_keyframe(self) -> int:
        """Sequences that inserted a keyframe in the window or the check
        chunks."""
        a, lo, hi = self.arena, self.window_frames[0], self.check_frames[1]
        n = 0
        for b in range(self.B):
            frames = [self._frame_of(float(a["kf_time"][b, k]))
                      for k in np.flatnonzero(a["kf_valid"][b].numpy())]
            n += any(lo <= f < hi for f in frames)
        return n

    def judged_keyframes(self):
        """(seq, slot, frame, check chunk, row of the copies) of the first
        keyframe each judged sequence inserted in each check chunk."""
        a, out = self.arena, []
        for c, (first, snap) in enumerate(self.snaps):
            n_kf = snap["n_kf"].cpu().numpy()
            for j, b in enumerate(self.check_seqs):
                slot = int(n_kf[j])
                if slot >= a["kf_valid"].shape[1] or not a["kf_valid"][b, slot]:
                    continue
                n = self._frame_of(float(a["kf_time"][b, slot]))
                if first <= n < first + self.chunk:
                    out.append((int(b), slot, n, c, j))
        return out

    def exact_pose(self, seq: int, bank: int):
        """The exact camera-to-world pose of a bank frame in the map's
        frame (the first frame's camera)."""
        R, t = self.paths[seq]
        R0t = R[0].T
        return R0t @ R[bank], R0t @ (t[bank] - t[0])

    def frame(self, seq: int, bank: int):
        return (torch.as_tensor(self.gray[bank, seq], device=self.device),
                torch.as_tensor(self.depth[bank, seq], device=self.device))

    def _cam(self):
        c = self.cam
        return (c.fx, c.fy, c.cx, c.cy)

    def _plain_step(self, kps, snap, j: int, mask, R, t, dtype):
        """The observations the plain step inserts for a keyframe with
        keypoints `kps`, matched against landmarks `mask` of the copied
        map row j, gated at pose (R, t): (Counter of (pixel, landmark or
        -1 for a new one), matched (landmark positions, pixels, depths))."""
        s = self.cfg["slam"]
        bits = kps.bits.to(torch.int8) * 2 - 1
        lm, dist, ok = ref_match.match_2nn(
            bits, kps.valid, snap["lm_desc"][j], mask,
            s["matcher"]["lowe_ratio"], s["matcher"]["max_hamming"], dtype)
        ok = ref_match.dedupe(lm, dist, ok)
        pw = snap["lm_pos"][j][lm]
        has_depth = kps.depth > 0
        inl = ok & has_depth & ref_match.inside_gates(
            pw, kps.uv, kps.depth, R, t, self._cam(),
            s["pnp"]["inlier_threshold_px"], s["pnp"]["depth_inlier_m"], dtype)
        new = (kps.valid & ~ok & has_depth
               & (kps.depth <= s["tracker"]["new_landmark_max_depth"]))
        uv = kps.uv.cpu().numpy().astype(np.float32)
        lm_h, inl_h, new_h = lm.cpu().numpy(), inl.cpu().numpy(), new.cpu().numpy()
        obs = Counter((uv[i].tobytes(), int(lm_h[i])) for i in np.flatnonzero(inl_h))
        obs.update((uv[i].tobytes(), -1) for i in np.flatnonzero(new_h))
        return obs, (pw[inl], kps.uv[inl], kps.depth[inl])

    def _port_step(self, b: int, slot: int, n_lm0: int) -> Counter:
        """The observations the port inserted for keyframe `slot` of
        sequence b: (pixel, landmark, or -1 for one it made then)."""
        a = self.arena
        rows = np.flatnonzero((a["obs_kf"][b] == slot).numpy()
                              & a["obs_valid"][b].numpy())
        uv = a["obs_uv"][b][rows].numpy().astype(np.float32)
        lm = a["obs_lm"][b][rows].numpy().astype(np.int64)
        return Counter((uv[i].tobytes(), int(lm[i]) if lm[i] < n_lm0 else -1)
                       for i in range(rows.shape[0]))

    def _pose_gaps(self, fits, dtype):
        """(gaps to the plain fit where its matches stay inside the gates,
        the other gaps to it, gaps to the exact pose), metres, of the
        judged keyframes' poses:
        the port's, or with `dtype` the control's fit in that precision."""
        f64, dev, M = torch.float64, self.device, len(fits)
        N = max([mm[0].shape[0] for f in fits for mm in f[4:6] if mm is not None]
                + [1])
        corr = torch.zeros((2, M, N, 6), dtype=f64, device=dev)  # pw, uv, z
        for i, f in enumerate(fits):
            for side, mm in enumerate(f[4:6]):
                if mm is not None:
                    k = mm[0].shape[0]
                    corr[side, i, :k] = torch.cat(
                        [mm[0].to(f64), mm[1].to(f64), mm[2].to(f64)[:, None]], 1)
        parts = [(c[..., 0:3], c[..., 3:5], c[..., 5], (c[..., 5] > 0).to(f64))
                 for c in corr]
        R0 = torch.as_tensor(np.stack([f[2] for f in fits]), device=dev)
        t0 = torch.as_tensor(np.stack([f[3] for f in fits]), device=dev)
        R_ref, t_ref = ref_track.refit_poses(*parts[0], R0, t0, self._cam())
        clear = (ref_track.gate_misses(*parts[0], R_ref, t_ref, self._cam()) == 0
                 ).cpu().numpy()
        if dtype is None:
            Rj, tj = torch.stack([f[0] for f in fits]), torch.stack([f[1] for f in fits])
        else:
            Rj, tj = ref_track.refit_poses(*parts[1], R0, t0, self._cam(), dtype=dtype)
        pts = ref_track.view_points(self._cam() + (self.cam.width, self.cam.height))
        Rj, tj = Rj.cpu().numpy(), tj.cpu().numpy()
        R_ref, t_ref = R_ref.cpu().numpy(), t_ref.cpu().numpy()
        to_fit = [ref_track.pose_gap_m(Rj[i], tj[i], R_ref[i], t_ref[i], pts)
                  for i in range(M)]
        exact = [ref_track.pose_gap_m(Rj[i], tj[i], fits[i][2], fits[i][3], pts)
                 for i in range(M)]
        return ([g for g, c in zip(to_fit, clear) if c],
                [g for g, c in zip(to_fit, clear) if not c], exact)

    def numbers(self, dtype=None) -> Dict[str, float]:
        """The compared numbers.  `dtype` None judges the port's outputs;
        a dtype puts the plain pipeline, run in that precision, in the
        port's place (the control)."""
        t_start = time.perf_counter()
        a = self.arena
        rng = np.random.default_rng([self.seed, 7])
        settings = self._settings()
        dev = self.device
        detections = {}

        def detect(b, n, low=None):
            key = (b, n % self.bank, low)
            if key not in detections:
                g, d = self.frame(b, n % self.bank)
                detections[key] = (ref_det.detect(g, d, settings) if low is None
                                   else ref_det.detect(g, d, settings, dtype=low))
            return detections[key]

        # keypoints: the last keyframe of a sample of sequences
        miss = total = 0
        for b in sorted(rng.choice(self.B, min(self.B, int(
                self.traffic["keypoint_sequences"])), replace=False)):
            slot = min(int(a["n_kf"][b]), a["kf_q"].shape[1]) - 1
            n = self._frame_of(float(a["kf_time"][b, slot]))
            ref = detect(b, n)
            if dtype is None:
                rows = ((a["obs_kf"][b] == slot) & a["obs_valid"][b]).nonzero()[:, 0]
                uv, dep = a["obs_uv"][b, rows], a["obs_depth"][b, rows]
                desc = a["lm_desc"][b, a["obs_lm"][b, rows].long()]
            else:
                low = detect(b, n, dtype)
                keep = (low.valid & (low.depth > 0)).cpu()
                uv, dep = low.uv.cpu()[keep], low.depth.cpu()[keep]
                desc = low.bits.cpu()[keep].to(torch.int8) * 2 - 1
            miss += _missing(ref, uv, dep, desc)
            total += uv.shape[0]

        # matches and poses: the first keyframe of each judged sequence in
        # each check chunk, against the map copied before that chunk
        depth = int(self.cfg["slam"]["tracker"]["covis_depth_tracking"])
        f64 = torch.float64
        masks = {}
        gap = union = ambiguous = 0
        fits = []     # (port R, port t, exact R, exact t, plain matches, judged)
        for b, slot, n, c, j in self.judged_keyframes():
            first, snap = self.snaps[c]
            if (c, j) not in masks:
                m = ref_match.covis_masks(snap["inc"][j], snap["kf_valid"][j],
                                          snap["lm_valid"][j], depth)
                rows = m[snap["kf_valid"][j]]
                masks[c, j] = m, bool(torch.all(rows == rows[:1]))
            m, same = masks[c, j]
            if same:
                mask = m[int(torch.nonzero(snap["kf_valid"][j])[0, 0])]
            elif n == first:
                mask = m[int(snap["ref_kf"][j])]
            else:
                ambiguous += 1
                continue
            _, pose = self.traj[b][n]
            Rp = torch.as_tensor(ref_track.quat_to_matrix(pose.q.numpy()), device=dev)
            tp = pose.t.to(dev, f64)
            plain, plain_m = self._plain_step(detect(b, n), snap, j, mask, Rp, tp, f64)
            if dtype is None:
                judged, judged_m = self._port_step(b, slot, int(snap["n_lm"][j])), None
            else:
                judged, judged_m = self._plain_step(detect(b, n, dtype), snap, j,
                                                    mask, Rp, tp, dtype)
            gap += sum(((plain - judged) + (judged - plain)).values())
            union += sum((plain | judged).values())
            R0, t0 = self.exact_pose(b, n % self.bank)
            fits.append((Rp, tp, R0, t0, plain_m, judged_m))

        M = len(fits)
        gaps, left_out, exact = (([], [], []) if M == 0
                                 else self._pose_gaps(fits, dtype))
        sound = self.sequences_with_a_keyframe() == self.B and M > 0
        return {"kp_miss_pct": 100.0 * miss / max(total, 1),
                "match_gap_pct": 100.0 * gap / max(union, 1) if sound else math.inf,
                "kf_pose_gap_mm": 1e3 * max(gaps) if sound and gaps else math.inf,
                "frames_not_tracked": float(self.failed + self.check_failed),
                "info.keyframes_judged": float(M),
                "info.keyframes_ambiguous": float(ambiguous),
                "info.keyframes_off_the_optimum_rule": float(len(left_out)),
                "info.kf_pose_gap_left_out_mm_max": 1e3 * max(left_out, default=0.0),
                "info.observations_matched": float(union),
                "info.observations_keypoint_checked": float(total),
                "info.kf_pose_err_vs_exact_mm_max": 1e3 * max(exact, default=0.0),
                "info.reference_s": time.perf_counter() - t_start,
                **{f"info.setup.{k}": v for k, v in self.setup_phases.items()},
                "info.setup.prefault_s": self.prefault_s}


def _missing(ref, uv: torch.Tensor, depth: torch.Tensor,
             desc: torch.Tensor) -> int:
    """Observations (uv [N, 2] float32, depth [N], desc [N, 256] int8 +-1)
    that are not a reference keypoint with that exact pixel, depth and
    descriptor."""
    ruv = ref.uv.cpu().numpy()
    keys = {}
    for i in np.flatnonzero(ref.valid.cpu().numpy()):
        keys.setdefault(ruv[i].tobytes(), []).append(i)
    rdesc = (ref.bits.cpu().to(torch.int8) * 2 - 1).numpy()
    rdep = ref.depth.cpu().numpy()
    uvn, dn, descn = uv.numpy(), depth.numpy(), desc.numpy()
    miss = 0
    for j in range(uvn.shape[0]):
        hits = keys.get(uvn[j].astype(np.float32).tobytes(), [])
        if not any(rdep[i] == dn[j] and np.array_equal(rdesc[i], descn[j])
                   for i in hits):
            miss += 1
    return miss
