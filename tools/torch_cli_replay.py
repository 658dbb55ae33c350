#!/usr/bin/env python3
"""The `cli` phase's full run of `chip_smoke.py` on the CPU, the JAX engine
and the port's on the same RANSAC draws.

    python tools/torch_cli_replay.py [--dataset DIR] [--frames N]
                                     [--record PATH]

Writes `chip_smoke.py`'s cli dataset into DIR (or reuses it there), then
runs the full preset of both packages with the phase's four overrides
the way their runners do (chunks of 16 in the wire format, deferred, the
tail frame by frame, `flush_backend`), JAX first: its RANSAC keys are
recorded and replayed to the port in the port's draw order, and every
global-BA tier is installed up front with no background compile
(`tests/test_torch_chunked.py::_pair`).  Prints one JSON object: each
side's frame and keyframe ATE, closures, keyframes, and the largest
frame-by-frame pose difference.  The JAX runner differs from this in
deferring a global BA whose tier is still compiling; the port's runner
draws from seed 0 what is replayed here.  Imports both packages; runs on
the CPU only.

`--record PATH` also writes what `chip_smoke.py`'s `cli_replay` phase
replays on the card (`modular_slam_tpu_torch/data/cli_jax_draws.npz`):
every draw, in the port's order, as the [n_hyp, 3] rows the JAX key
gives (int16), the JAX run's frame and keyframe ATE, closures,
keyframes and per-frame flags, the port's CPU figures beside them, and
the dataset's arguments and the overrides they hold for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402


class _Recorder:
    """The replay queue's draws, kept as the port takes them."""

    def __init__(self, queue):
        self.queue, self.draws = queue, []

    @property
    def keys(self):
        return self.queue.keys

    def __call__(self, valid, n_hyp):
        idx = self.queue(valid, n_hyp)
        self.draws.append(idx.numpy().astype(np.int16))
        return idx


def _trajectory(system) -> np.ndarray:
    """A system's frame trajectory as TUM rows [N, 8], float64: the port's
    poses are tensors, the JAX engine's arrays."""
    rows = []
    for ts, pose in system.trajectory:
        q, t = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
                for x in (pose.q, pose.t))
        rows.append([ts, *t, *q[1:], q[0]])
    return np.array(rows)


class _Patch:
    """The `setattr` of pytest's monkeypatch, for `_pair`."""

    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--record", default=None, metavar="PATH")
    args = ap.parse_args()

    from modular_slam_tpu.config import SlamConfig as JaxSlamConfig
    from modular_slam_tpu.run import apply_overrides as jax_overrides
    from modular_slam_tpu_torch.eval.ate import ate_rmse
    from modular_slam_tpu_torch.io.tum import TumRgbdDataset
    from tests.test_torch_chunked import _pair

    ds_dir = args.dataset or os.path.join(tempfile.mkdtemp(), "loop")
    if not os.path.exists(os.path.join(ds_dir, "rgb.txt")):
        chip_smoke.write_cli_dataset(ds_dir)
    ds = TumRgbdDataset(ds_dir)
    n = min(len(ds), args.frames or len(ds))
    cfg = jax_overrides(JaxSlamConfig().replace(camera=ds.camera),
                        chip_smoke.CLI_OVERRIDES)
    jsys, tsys, queue, _ = _pair(
        _Patch(), cfg, enable_backend=True, enable_loop_closure=True,
        enable_relocalization=True, defer_chunk_sync=True)
    recorder = _Recorder(queue)
    tsys.sampler = recorder
    chip_smoke.run_like_runner(jsys, ds, n)   # JAX first: it records keys
    n_keys = len(queue.keys)
    chip_smoke.run_like_runner(tsys, ds, n)
    gt = ds.groundtruth
    out = {"frames": n, "keys": n_keys, "keys_left": len(queue.keys),
           "draws_recorded": len(recorder.draws)}
    for name, s in (("jax", jsys), ("port", tsys)):
        out[name] = {
            "ate_rmse_m": ate_rmse(_trajectory(s), gt,
                                   max_difference=0.05)["rmse"],
            "kf_ate_rmse_m": ate_rmse(s.keyframe_trajectory(), gt,
                                      max_difference=0.05)["rmse"],
            "loop_closures": s.n_loop_closures,
            "keyframes": int(s.n_keyframes)}
    jt, tt = (_trajectory(s) for s in (jsys, tsys))
    out["max_pose_diff_m"] = float(np.abs(jt[:, 1:4] - tt[:, 1:4]).max())
    out["same_flags"] = all(
        bool(a.tracking_ok) == bool(b.tracking_ok)
        and bool(a.new_keyframe) == bool(b.new_keyframe)
        for a, b in zip(jsys.results, tsys.results))
    print(json.dumps(out))
    if args.record:
        if len(recorder.draws) != n_keys or queue.keys:
            raise SystemExit(f"draws: {len(recorder.draws)} taken of "
                             f"{n_keys}")
        _save(args.record, recorder.draws, jsys, out)
    return 0


def _save(path: str, draws, jsys, out: dict) -> None:
    flags = np.array([[bool(r.tracking_ok), bool(r.new_keyframe)]
                      for r in jsys.results])
    np.savez_compressed(
        path, draws=np.stack(draws), jax_tracking_ok=flags[:, 0],
        jax_new_keyframe=flags[:, 1],
        jax_ate_rmse_m=out["jax"]["ate_rmse_m"],
        jax_kf_ate_rmse_m=out["jax"]["kf_ate_rmse_m"],
        jax_loop_closures=out["jax"]["loop_closures"],
        jax_keyframes=out["jax"]["keyframes"],
        port_cpu_ate_rmse_m=out["port"]["ate_rmse_m"],
        port_cpu_kf_ate_rmse_m=out["port"]["kf_ate_rmse_m"],
        frames=out["frames"],
        dataset=json.dumps(chip_smoke.CLI_DATASET, sort_keys=True),
        overrides=np.array(chip_smoke.CLI_OVERRIDES))


if __name__ == "__main__":
    sys.exit(main())
