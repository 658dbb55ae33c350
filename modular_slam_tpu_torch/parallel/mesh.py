"""Device grids (counterpart of modular_slam_tpu/parallel/mesh.py:
`make_mesh`, `make_kf_mesh`).

A `Mesh` is a named 2-D grid of `torch.device`s:
- axis "seq": data parallelism over independent sequences (BASELINE
  config 5; parallel/dp.py runs one contiguous group of the batch on each
  row's first device), and
- axis "obs" (or "kf" first, for `make_kf_mesh`): the devices a row's
  sharded BA would share.

By default the grid holds every CUDA device, so on one H100 it is 1x1.
The constructors raise where the JAX ones do; with no CUDA device and no
`devices` given they raise as the port's other entry points do.  CPU
tests pass a repeated `torch.device("cpu")`, as the JAX tests use virtual
CPU devices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: np.ndarray            # [rows, cols] object array of devices
    axis_names: Tuple[str, str]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def _devices(devices: Optional[Sequence]) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] "
                           "(e.g. torch.device('cpu')) to build a CPU grid")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(rows: int, cols: Optional[int], devices, names) -> Mesh:
    devs = _devices(devices)
    n = len(devs)
    if cols is None:
        if n % rows != 0:
            raise ValueError(f"{n} devices not divisible by {names[0]}="
                             f"{rows}")
        cols = n // rows
    if rows * cols != n:
        raise ValueError(f"mesh {rows}x{cols} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(rows, cols), names)


def make_mesh(seq: int = 1, obs: Optional[int] = None,
              devices=None) -> Mesh:
    """Grid with axes ("seq", "obs").  `obs` defaults to all remaining
    devices."""
    return _grid(seq, obs, devices, ("seq", "obs"))


def make_kf_mesh(kf: int = 1, obs: Optional[int] = None,
                 devices=None) -> Mesh:
    """Grid with axes ("kf", "obs") for keyframe-block sharded global BA
    (BASELINE config 4)."""
    return _grid(kf, obs, devices, ("kf", "obs"))
