"""Pipeline presets (counterpart of modular_slam_tpu/models/pipelines.py).

- "odometry": tracking only;
- "slam":     tracking + local BA per keyframe;
- "full":     tracking + local BA + loop closure + relocalization.

Keyword arguments go to `SlamSystem`, whose `device` defaults to "cuda".
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import SlamSystem


def odometry_pipeline(cfg: Optional[SlamConfig] = None, **kw) -> SlamSystem:
    return SlamSystem(cfg or SlamConfig(), enable_backend=False, **kw)


def slam_pipeline(cfg: Optional[SlamConfig] = None, **kw) -> SlamSystem:
    return SlamSystem(cfg or SlamConfig(), enable_backend=True, **kw)


def full_slam_pipeline(cfg: Optional[SlamConfig] = None, **kw) -> SlamSystem:
    return SlamSystem(cfg or SlamConfig(), enable_backend=True,
                      enable_loop_closure=True, enable_relocalization=True,
                      **kw)


PIPELINES: Dict[str, Callable[..., SlamSystem]] = {
    "odometry": odometry_pipeline,
    "slam": slam_pipeline,
    "full": full_slam_pipeline,
}


def make_pipeline(name: str, cfg: Optional[SlamConfig] = None,
                  **kw) -> SlamSystem:
    if name not in PIPELINES:
        raise KeyError(
            f"unknown pipeline {name!r}; one of {sorted(PIPELINES)}")
    return PIPELINES[name](cfg, **kw)
