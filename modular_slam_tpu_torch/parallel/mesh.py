"""Device grids (counterpart of modular_slam_tpu/parallel/mesh.py:
`make_mesh`, `make_kf_mesh`, `obs_sharded_specs`, `replicate`).

A `Mesh` is a named 2-D grid of `torch.device`s:
- axis "seq": data parallelism over independent sequences (BASELINE
  config 5; parallel/dp.py runs one contiguous group of the batch on each
  row's first device), and
- axis "obs" (or "kf" first, for `make_kf_mesh`): the devices a row's
  sharded BA shares.

By default the grid holds every CUDA device, so on one H100 it is 1x1.
Once a process group is initialized (parallel/bootstrap.py), a grid built
with no `devices` is one over the group's ranks instead, one device per
rank, as `jax.devices()` is global after `jax.distributed.initialize`.
Such a grid also carries the global rank at each position, this rank's
coordinates, and for each axis the process group of the ranks along it
that holds this rank (`group`): the sharded bundle adjustments
(sharded_ba.py, kf_sharded_ba.py, halo_ba.py) run their collectives on
those.  Building it creates one group per row and one per column on every
rank, in the same order (`torch.distributed.new_group` is collective), so
every rank must build the same grids.

The constructors raise where the JAX ones do; with no CUDA device, no
process group and no `devices` given they raise as the port's other entry
points do.  CPU tests pass a repeated `torch.device("cpu")`, as the JAX
tests use virtual CPU devices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: np.ndarray            # [rows, cols] object array of devices
    axis_names: Tuple[str, str]
    # process-group grids only:
    ranks: Optional[np.ndarray] = dataclasses.field(default=None,
                                                    compare=False)
    coords: Optional[Dict[str, int]] = None
    groups: Optional[Dict[str, Any]] = dataclasses.field(default=None,
                                                         compare=False)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device(self) -> torch.device:
        """This rank's device (a process-group grid)."""
        self._require_group()
        return self.devices[tuple(self.coords[a] for a in self.axis_names)]

    def group(self, axis: str):
        """The process group of the ranks along `axis` that holds this
        rank."""
        self._require_group()
        return self.groups[axis]

    def axis_ranks(self, axis: str) -> list:
        """Global ranks along `axis` through this rank, by coordinate."""
        self._require_group()
        a = self.axis_names.index(axis)
        pos = [self.coords[n] for n in self.axis_names]
        pos[a] = slice(None)
        return [int(r) for r in self.ranks[tuple(pos)]]

    def _require_group(self) -> None:
        if self.groups is None:
            raise ValueError("this mesh is a grid of local devices; the "
                             "sharded bundle adjustments need one built "
                             "over an initialized process group "
                             "(parallel/bootstrap.initialize_distributed)")


def _rank_device(rank: int) -> torch.device:
    """The device a rank drives: the CPU under gloo, else its card."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _devices(devices: Optional[Sequence]) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass devices=[...] "
                           "(e.g. torch.device('cpu')) to build a CPU grid")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _shape(rows: int, cols: Optional[int], n: int, names) -> Tuple[int, int]:
    if cols is None:
        if n % rows != 0:
            raise ValueError(f"{n} devices not divisible by {names[0]}="
                             f"{rows}")
        cols = n // rows
    if rows * cols != n:
        raise ValueError(f"mesh {rows}x{cols} != {n} devices")
    return rows, cols


def _grid(rows: int, cols: Optional[int], devices, names) -> Mesh:
    if devices is None and dist.is_available() and dist.is_initialized():
        return _group_grid(rows, cols, names)
    devs = _devices(devices)
    rows, cols = _shape(rows, cols, len(devs), names)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(rows, cols), names)


def _group_grid(rows: int, cols: Optional[int], names) -> Mesh:
    """The world's ranks, row-major, with a group per row and column."""
    n, me = dist.get_world_size(), dist.get_rank()
    rows, cols = _shape(rows, cols, n, names)
    ranks = np.arange(n).reshape(rows, cols)
    devs = np.empty(n, dtype=object)
    devs[:] = [_rank_device(r) for r in range(n)]
    r0, c0 = (int(v) for v in np.argwhere(ranks == me)[0])
    groups = {}
    # every rank creates every group, in this order
    for i in range(rows):
        g = dist.new_group([int(r) for r in ranks[i]])
        if i == r0:
            groups[names[1]] = g       # a row: the ranks along axis 1
    for j in range(cols):
        g = dist.new_group([int(r) for r in ranks[:, j]])
        if j == c0:
            groups[names[0]] = g       # a column: the ranks along axis 0
    return Mesh(devs.reshape(rows, cols), names, ranks,
                {names[0]: r0, names[1]: c0}, groups)


def make_mesh(seq: int = 1, obs: Optional[int] = None,
              devices=None) -> Mesh:
    """Grid with axes ("seq", "obs").  `obs` defaults to all remaining
    devices."""
    return _grid(seq, obs, devices, ("seq", "obs"))


def make_kf_mesh(kf: int = 1, obs: Optional[int] = None,
                 devices=None) -> Mesh:
    """Grid with axes ("kf", "obs") for keyframe-block sharded global BA
    (BASELINE config 4): keyframe/landmark state blocks over "kf",
    observation rows over both axes."""
    return _grid(kf, obs, devices, ("kf", "obs"))


class Spec(NamedTuple):
    """How a tensor's rows lie on a mesh, the port's PartitionSpec of the
    leading dimension: split over `axes` (row-major over them, as
    `P((a, b))`), or replicated when empty."""
    axes: Tuple[str, ...] = ()


def obs_sharded_specs() -> Tuple[Spec, Spec]:
    """Specs for (replicated map state, obs-sharded edge list)."""
    return Spec(), Spec(("obs",))


def local_rows(mesh: Mesh, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's block of x's rows under `spec` (x itself when
    replicated); the row count must divide by the axes' sizes."""
    n, i = 1, 0
    for a in spec.axes:
        i = i * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {spec.axes}"
                         f" of size {n}")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def _broadcast(x: torch.Tensor, device, src: int) -> torch.Tensor:
    x = x.to(device).contiguous().clone()
    # bool goes over the wire as bytes (gloo has no bool)
    dist.broadcast(x.view(torch.uint8) if x.dtype == torch.bool else x,
                   src=src)
    return x


def replicate(mesh: Mesh, tree):
    """Rank 0's tensors of `tree` (a tensor, or a NamedTuple, tuple, list
    or dict of them) on every rank's device; every rank passes a tree of
    the same structure, shapes and dtypes."""
    dev, src = mesh.device, int(mesh.ranks.flat[0])
    if isinstance(tree, torch.Tensor):
        return _broadcast(tree, dev, src)
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(mesh, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return tree
