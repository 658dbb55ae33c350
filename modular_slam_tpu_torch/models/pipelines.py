"""Pipeline presets (counterpart of modular_slam_tpu/models/pipelines.py).

"odometry" (tracking only) and "slam" (tracking + local BA per keyframe)
are ported; "full" (loop closure, relocalization) raises
NotImplementedError naming its ROADMAP.md item.  Keyword arguments go to
`SlamSystem`, whose `device` defaults to "cuda".
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import SlamSystem

_LATER = {"full": 3}


def odometry_pipeline(cfg: Optional[SlamConfig] = None, **kw) -> SlamSystem:
    return SlamSystem(cfg or SlamConfig(), enable_backend=False, **kw)


def slam_pipeline(cfg: Optional[SlamConfig] = None, **kw) -> SlamSystem:
    return SlamSystem(cfg or SlamConfig(), enable_backend=True, **kw)


PIPELINES: Dict[str, Callable[..., SlamSystem]] = {
    "odometry": odometry_pipeline,
    "slam": slam_pipeline,
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
