"""Pipeline presets (counterpart of modular_slam_tpu/models/pipelines.py).

Only "odometry" (tracking only) is ported; "slam" (local BA) and "full"
(loop closure, relocalization) raise NotImplementedError naming their
ROADMAP.md item.  Keyword arguments go to `SlamSystem`, whose `device`
defaults to "cuda".
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import SlamSystem

_LATER = {"slam": 1, "full": 3}


def odometry_pipeline(cfg: Optional[SlamConfig] = None, **kw) -> SlamSystem:
    return SlamSystem(cfg or SlamConfig(), enable_backend=False, **kw)


PIPELINES: Dict[str, Callable[..., SlamSystem]] = {
    "odometry": odometry_pipeline,
}


def make_pipeline(name: str, cfg: Optional[SlamConfig] = None,
                  **kw) -> SlamSystem:
    if name in _LATER:
        raise NotImplementedError(
            f"pipeline {name!r} is not ported to PyTorch yet (ROADMAP.md, "
            f"'Next slices', item {_LATER[name]})")
    if name not in PIPELINES:
        raise KeyError(
            f"unknown pipeline {name!r}; one of {sorted(PIPELINES)}")
    return PIPELINES[name](cfg, **kw)
