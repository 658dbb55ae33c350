#!/usr/bin/env python3
"""How far apart two converged global-BA solves of one map may land, in
float32 and in float64, on the card and the CPU.

    python tools/torch_gba_determinacy.py [--runs N]

Builds `chip_smoke.py`'s `slam_fast_motion` map on the card (48 frames at
640x480, 8 keyframes) and runs the compact global BA at its converged
budget (200 CG steps, 10 LM iterations, no early stop) N times on the
card: run 0 on the map as it is, run i > 0 with the landmarks moved by
1e-7 relative (seed i), once in float32 and once on a float64 copy of the
map, plus one CPU solve of each.  Reports each solve's largest keyframe
translation from the float64 optimum (the card's run 0), and the float64
cost along the line from that optimum to the float32 solve farthest from
it: the slope that float32 residuals would have to resolve.  Prints one
JSON object.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, HERE)

    import torch

    import chip_smoke as cs
    from modular_slam_tpu_torch.backend.ba import (global_ba_tier,
                                                   make_global_ba_compact)
    from modular_slam_tpu_torch.config import SlamConfig
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("torch_gba_determinacy: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = SlamConfig()
    gen = PlaneSceneGenerator(cfg.camera, seed=0)
    poses = gen.trajectory(
        cs.N_FRAMES, step_t=tuple(cs.FAST_MOTION * x for x in cs.STEP_T),
        step_rot=tuple(cs.FAST_MOTION * x for x in cs.STEP_ROT))
    cs.phase_build(kernels)
    system = cs.phase_slam(torch, kernels, list(gen.sequence(poses)), poses,
                           cfg, phase="slam_fast_motion")
    tier = global_ba_tier(system.arena)

    def budget(iters):
        return dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, gba_cg_iters=200, gba_early_stop_rtol=None,
            gba_max_iterations=iters))

    def solve(arena, device, dtype, iters=10):
        a, st = make_global_ba_compact(budget(iters), tier, device=device)(
            cs._arena_on(arena, device, dtype))
        return cs._arena_on(a, "cpu", torch.float64), float(st.final_cost)

    def moved(i):
        if i == 0:
            return system.arena
        g = torch.Generator().manual_seed(i)
        lm = system.arena.lm_pos.cpu()
        noise = 1 + 1e-7 * torch.randn(lm.shape, generator=g)
        return system.arena._replace(lm_pos=(lm * noise).to(lm.device))

    runs = {"float32": [], "float64": []}
    for name, dtype in (("float32", None), ("float64", torch.float64)):
        for i in range(args.runs):
            runs[name].append(("cuda", i) + solve(moved(i), "cuda", dtype))
        runs[name].append(("cpu", 0) + solve(system.arena, "cpu", dtype))
    opt = runs["float64"][0][2]
    valid = opt.kf_valid

    def dist(a):
        return cs._pose_diffs(torch, a.kf_q, a.kf_t, opt.kf_q, opt.kf_t,
                              valid)

    report = {name: [{"device": d, "perturbed_seed": i,
                      "max_dt_m": dist(a)[0], "max_drot_rad": dist(a)[1],
                      "final_cost": c} for d, i, a, c in rows]
              for name, rows in runs.items()}
    far = max(runs["float32"], key=lambda r: dist(r[2])[0])[2]

    def cost64_at(s):
        q = opt.kf_q + s * (far.kf_q - opt.kf_q)
        point = opt._replace(
            kf_q=q / q.norm(dim=-1, keepdim=True),
            kf_t=opt.kf_t + s * (far.kf_t - opt.kf_t),
            lm_pos=opt.lm_pos + s * (far.lm_pos - opt.lm_pos),
            obs_valid=system.arena.obs_valid.cpu())
        return solve(point, "cpu", torch.float64, iters=0)[1]

    line = [(s, cost64_at(s)) for s in (0.0, 0.5, 1.0, 1.5)]
    print(json.dumps({"tier": tier, "runs": report,
                      "float32_farthest_m": dist(far)[0],
                      "float64_cost_along_line": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
