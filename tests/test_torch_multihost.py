"""2-process bootstrap of the port (the counterpart of
tests/test_multihost.py): two OS processes join one gloo process group
through parallel/bootstrap.py from the SLAM_* environment, run the BA
reduction pattern (obs-sharded segment sum + all-reduce) against
`np.add.at`, then the halo-sharded global BA over the 2-rank grid
(tests/_torch_multihost_worker.py)."""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.test_backend_ba import CAM_CFG, _build_problem

_WORKER = os.path.join(os.path.dirname(__file__),
                       "_torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_bootstrap_and_halo_ba(tmp_path):
    # the problem of tests/_multihost_worker.py, handed over as numpy
    _, arena, _, _ = _build_problem(seed=7)
    problem = str(tmp_path / "problem.npz")
    np.savez(problem, **{k: np.asarray(v) for k, v in
                         arena._asdict().items()},
             **{"cam_" + k: v for k, v in
                dataclasses.asdict(CAM_CFG).items()
                if k in ("fx", "fy", "cx", "cy", "width", "height")})
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update({
            "SLAM_COORDINATOR": f"127.0.0.1:{port}",
            "SLAM_NUM_PROCESSES": "2",
            "SLAM_PROCESS_ID": str(rank),
        })
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, problem], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {rank} timed out")
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"MH OK rank={rank}" in out, out[-3000:]
        # the distributed Schur-complement BA (halo-sharded: sends and
        # all-reduces over gloo) converged across the process boundary
        assert f"MH HALO OK rank={rank}" in out, out[-3000:]
