#!/usr/bin/env python3
"""The `cli` phase's full run of `chip_smoke.py` on the CPU, the JAX engine
and the port's on the same RANSAC draws.

    python tools/torch_cli_replay.py [--dataset DIR] [--frames N]

Writes `chip_smoke.py`'s cli dataset into DIR (or reuses it there), then
runs the full preset of both packages with the phase's four overrides
the way their runners do (chunks of 16 in the wire format, deferred, the
tail frame by frame, `flush_backend`), JAX first: its RANSAC keys are
recorded and replayed to the port in the port's draw order, and every
global-BA tier is installed up front with no background compile
(`tests/test_torch_chunked.py::_pair`).  Prints one JSON object: each
side's frame and keyframe ATE, closures, keyframes, and the largest
frame-by-frame pose difference.  The runners differ from this in their
draws and, on the JAX side, in deferring a global BA whose tier is still
compiling.  Imports both packages; runs on the CPU only.
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


class _Patch:
    """The `setattr` of pytest's monkeypatch, for `_pair`."""

    def setattr(self, obj, name, value):
        setattr(obj, name, value)


def _run(system, ds, n: int, chunk: int = 16) -> None:
    """`run.py`'s loop: full chunks in the wire format, the tail frame by
    frame, then `flush_backend`."""
    buf = []
    for i, (gray, depth, ts) in enumerate(ds.wire_iter(native_ok=False)):
        if i >= n:
            break
        buf.append((gray, depth, ts))
        if len(buf) == chunk:
            system.process_chunk_wire(*zip(*buf))
            buf = []
    for gray, depth, ts in buf:
        system.process(np.repeat(gray[..., None], 3, axis=-1),
                       depth.astype(np.float32) * ds.camera.depth_factor, ts)
    system.flush_backend()


def _trajectory(system) -> np.ndarray:
    rows = []
    for ts, pose in system.trajectory:
        q, t = np.asarray(pose.q, np.float64), np.asarray(pose.t, np.float64)
        rows.append([ts, *t, *q[1:], q[0]])
    return np.array(rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--frames", type=int, default=None)
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
    _run(jsys, ds, n)                  # JAX first: it records the keys
    _run(tsys, ds, n)
    gt = ds.groundtruth
    out = {"frames": n, "keys_left": len(queue.keys)}
    for name, s in (("jax", jsys), ("port", tsys)):
        out[name] = {
            "ate_rmse_m": ate_rmse(_trajectory(s), gt,
                                   max_difference=0.05)["rmse"],
            "kf_ate_rmse_m": ate_rmse(s.keyframe_trajectory(), gt,
                                      max_difference=0.05)["rmse"],
            "loop_closures": s.n_loop_closures,
            "keyframes": int(s.n_keyframes)}
    jt, tt = _trajectory(jsys), _trajectory(tsys)
    out["max_pose_diff_m"] = float(np.abs(jt[:, 1:4] - tt[:, 1:4]).max())
    out["same_flags"] = all(
        bool(a.tracking_ok) == bool(b.tracking_ok)
        and bool(a.new_keyframe) == bool(b.new_keyframe)
        for a, b in zip(jsys.results, tsys.results))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
