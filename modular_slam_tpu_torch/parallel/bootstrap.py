"""Multi-process bootstrap on `torch.distributed` (counterpart of
modular_slam_tpu/parallel/bootstrap.py).

The JAX module initializes `jax.distributed` so that one shard_map BA runs
over the devices of several processes.  Here each process is one rank
driving one device: `initialize_distributed` joins the ranks in a process
group, and `global_mesh` lays them out as the ("seq", "obs") grid the
sharded bundle adjustment (parallel/sharded_ba.py) runs on.

Environment contract (the JAX module's):
    SLAM_COORDINATOR   host:port of rank 0 (required when >1 process)
    SLAM_NUM_PROCESSES total process count           (default 1)
    SLAM_PROCESS_ID    this process's rank           (default 0)
    SLAM_CPU_GLOO      "1": gloo collectives on the CPU

The backend is NCCL on the card; `cpu_gloo=True` (or SLAM_CPU_GLOO=1)
selects gloo, with every rank on the CPU: how the tests run several ranks
without a card (tests/test_torch_multihost.py).  With no card and no
gloo request it raises, as the port's other entry points do.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from modular_slam_tpu_torch.parallel.mesh import make_mesh


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_gloo: bool = False,
) -> bool:
    """Join this process to the process group.

    Arguments default from the SLAM_* environment variables.  Returns
    True when a process group was initialized, False for a single
    process with no coordinator (a local run: nothing to join)."""
    coordinator = coordinator or os.environ.get("SLAM_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SLAM_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("SLAM_PROCESS_ID", "0") or 0)
    gloo = cpu_gloo or os.environ.get("SLAM_CPU_GLOO") == "1"

    if coordinator is None and num_processes <= 1:
        return False
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need SLAM_COORDINATOR "
                         f"(host:port of rank 0)")
    if gloo:
        backend = "gloo"
    elif torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    else:
        raise RuntimeError("initialize_distributed: no CUDA device; pass "
                           "cpu_gloo=True (or SLAM_CPU_GLOO=1) to run the "
                           "ranks on the CPU")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=max(num_processes, 1),
                            rank=process_id)
    return True


def global_mesh(seq: int = 1, obs: Optional[int] = None):
    """("seq", "obs") grid over ALL ranks of the process group."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh: no process group; call "
                           "initialize_distributed first")
    return make_mesh(seq=seq, obs=obs)


def process_info() -> dict:
    """Rank/size/device summary for logs and the CLI banner (the JAX
    keys; each rank drives one device)."""
    on = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if on else 1
    return {
        "process_id": dist.get_rank() if on else 0,
        "num_processes": n,
        "local_devices": 1,
        "global_devices": n,
    }
