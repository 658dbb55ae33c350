"""Host -> device transfers that do not wait for the device.

A tensor made from host data on the card is a synchronous copy: it waits
for every kernel queued before it.  In a step that should queue a whole
chunk of frames without a host sync, constants are therefore made once
per device and kept (`constant`), and per-frame host data goes through
pinned memory with `non_blocking=True` (`upload`).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_CONSTANTS: Dict[Tuple[Hashable, torch.device], Tensor] = {}


def constant(key: Hashable, make: Callable[[], object], device) -> Tensor:
    """The tensor `make()` (array-like) on `device`, made at the first
    call for this key and device and shared afterwards: callers must not
    write into it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _CONSTANTS.get((key, dev))
    if t is None:
        t = torch.as_tensor(make()).to(dev)
        _CONSTANTS[(key, dev)] = t
    return t


def upload(array, device) -> Tensor:
    """Host array -> tensor on `device`; to the card through pinned
    memory with non_blocking=True, which waits for nothing queued there."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
