"""The global-BA traffic: the port's `backend/ba.py::make_global_ba_compact`
called again and again at one tier on one map, as the loop pipeline calls
it on every closure once a long run's map has reached highwater.

Set-up makes the map from the seed (`gba_map.py`) at the configuration's
counts, loads it into the port's arena, and makes one call to warm up.
Each call of the window gets a fresh copy of that arena, since the call
updates it in place; the copy is part of the call's time.

The output check judges the first and the last call of the window
against the plain solver (`reference/gba.py`, float64, Levenberg-Marquardt
to convergence with an exact Schur solve) on the same map:

- `cost_gap`: (cost of the port's solution - the optimum) / (starting
  cost - the optimum), all in float64: the share of the possible descent
  the solve left undone (poses, landmarks and costs together);
- `outlier_rows`: observations whose outlier flag (the port clears
  `obs_valid`) differs from the plain classification at the port's own
  solution.

Printed beside them and not compared: `info.pose_gap_mm`, the largest
distance between where the port's and the optimum's keyframe poses put
the camera centre and the corners of the view at 2 m.  The loop's soft
drift mode leaves it at tens of mm for a sound solve, and the control
reads it only ~1.5x higher: it cannot separate the two.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from port_bench.gba_map import make_map
from port_bench.reference import gba as ref_gba
from port_bench.reference import track as ref_track


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        s = cfg["sensor"]
        self.cam6 = (s["fx"], s["fy"], s["cx"], s["cy"], s["width"], s["height"])
        m = cfg["map"]
        self.counts = (int(m["keyframes"]), int(m["landmarks"]),
                       int(m["observations"]))

    def _arena(self):
        """The map in the port's arena, on the card."""
        from modular_slam_tpu_torch.map.arena import empty_arena

        from port_bench.drivers.fleet import slam_config

        d, (K, L, O) = self.map, self.counts
        a = empty_arena(slam_config(self.cfg).map, self.device)
        dev = self.device

        def put(dst, src, dtype=torch.float32):
            dst[:src.shape[0]] = torch.as_tensor(src, device=dev).to(dtype)

        put(a.kf_q, ref_track.matrix_to_quat(d.R0))
        put(a.kf_t, d.t0)
        put(a.kf_time, np.arange(K) * float(self.cfg["map"]["kf_period_s"]))
        a.kf_valid[:K] = True
        put(a.lm_pos, d.lm0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.default_rng([self.seed, 3]).integers(0, 2 ** 62)))
        a.lm_desc[:L] = (torch.randint(0, 2, (L, a.lm_desc.shape[1]), generator=gen,
                                       device=dev) * 2 - 1).to(torch.int8)
        a.lm_valid[:L] = True
        kf = torch.as_tensor(d.obs_kf, device=dev)
        lm = torch.as_tensor(d.obs_lm, device=dev)
        a.inc[kf, lm] = True
        put(a.obs_kf, d.obs_kf, torch.int32)
        put(a.obs_lm, d.obs_lm, torch.int32)
        put(a.obs_uv, d.uv)
        put(a.obs_depth, d.depth)
        a.obs_valid[:O] = True
        a.n_kf.fill_(K)
        a.n_lm.fill_(L)
        a.n_obs.fill_(O)
        return a

    def setup(self) -> None:
        from modular_slam_tpu_torch.backend.ba import make_global_ba_compact

        from port_bench.drivers.fleet import slam_config

        m = self.cfg["map"]
        self.map = make_map(self.seed, self.cam6, *self.counts, m["room"],
                            self.traffic["noise"])
        self.arena = self._arena()
        torch.cuda.synchronize(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        self.gba = make_global_ba_compact(slam_config(self.cfg),
                                          tuple(self.traffic["tier"]),
                                          device=self.device)
        for _ in range(int(self.traffic["warmup_calls"])):
            self._call()
        torch.cuda.synchronize(self.device)

    def _call(self):
        copy = type(self.arena)(*[x.clone() for x in self.arena])
        return self.gba(copy)

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        calls, first, last = 0, None, None
        self.iterations, self.call_ends = [], []
        while time.perf_counter() - t0 < seconds:
            last = self._call()
            first = first or last
            self.iterations.append(last[1].n_iterations)
            self.call_ends.append(time.perf_counter() - t0)
            calls += 1
        torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.judged = [first, last] if calls > 1 else [first]
        self.attempted, self.failed = calls, 0
        return {"gba_ms": 1e3 * elapsed / calls}

    def traced_work(self):
        n = int(self.traffic["trace_calls"])

        def run():
            for _ in range(n):
                self._call()
        return run, n

    def shapes(self) -> dict:
        return {"tier": list(self.traffic["tier"])}

    def collect(self) -> None:
        K, L, O = self.counts
        self.out = []
        for arena, stats in self.judged:
            self.out.append({
                "q": arena.kf_q[:K].double().cpu().numpy(),
                "t": arena.kf_t[:K].double().cpu(),
                "lm": arena.lm_pos[:L].double().cpu(),
                "outlier": (~arena.obs_valid[:O]).cpu()})
        del self.judged, self.arena, self.gba
        torch.cuda.empty_cache()

    def _problem(self) -> ref_gba.Problem:
        d, dev = self.map, self.device
        T = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        return ref_gba.Problem(T(d.R0), T(d.t0), T(d.lm0), T(d.obs_kf),
                               T(d.obs_lm), T(d.uv).double(), T(d.depth).double(),
                               tuple(float(c) for c in self.cam6[:4]))

    def numbers(self, dtype=None) -> Dict[str, float]:
        """The compared numbers of the judged calls (the worst of them).
        `dtype` None judges the port's outputs; a dtype puts the plain
        solver, run in that precision, in the port's place (the control)."""
        p = self._problem()
        R_opt, t_opt, lm_opt, c_opt = ref_gba.solve(p)
        c0 = ref_gba.cost_of(p, p.R_wc, p.t_wc, p.lm)
        pts = ref_track.view_points(self.cam6)
        if dtype is None:
            sols = []
            for o in self.out:
                R = torch.as_tensor(np.stack([ref_track.quat_to_matrix(q)
                                              for q in o["q"]]), device=self.device)
                sols.append((R, o["t"].to(self.device), o["lm"].to(self.device),
                             o["outlier"].to(self.device)))
        else:
            R, t, lm, _ = ref_gba.solve(p, dtype=dtype)
            R, t, lm = R.double(), t.double(), lm.double()
            sols = [(R, t, lm, ref_gba.outliers(p, R, t, lm, dtype=dtype))]
        out = {"cost_gap": -np.inf, "outlier_rows": 0.0, "info.pose_gap_mm": 0.0}
        Ro, to = R_opt.cpu().numpy(), t_opt.cpu().numpy()
        for R, t, lm, flags in sols:
            c = ref_gba.cost_of(p, R, t, lm)
            gap = max(ref_track.pose_gap_m(R[k].cpu().numpy(), t[k].cpu().numpy(),
                                           Ro[k], to[k], pts)
                      for k in range(R.shape[0]))
            rows = int((flags != ref_gba.outliers(p, R, t, lm)).sum())
            out["cost_gap"] = max(out["cost_gap"], (c - c_opt) / (c0 - c_opt))
            out["info.pose_gap_mm"] = max(out["info.pose_gap_mm"], 1e3 * gap)
            out["outlier_rows"] = max(out["outlier_rows"], float(rows))
        out["info.optimum_cost"] = c_opt
        out["info.lm_iterations_min"] = float(min(self.iterations))
        out["info.lm_iterations_max"] = float(max(self.iterations))
        out["info.start_cost"] = c0
        return out
