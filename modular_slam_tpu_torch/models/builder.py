"""Fluent SLAM system builder (counterpart of
modular_slam_tpu/models/builder.py): pick components by registry name,
register frame observers, build a runnable system.

    system = (SlamBuilder(cfg)
              .with_device("cuda")
              .with_detector("orb_grid")
              .with_pipeline("full")
              .on_frame(lambda ts, pose, res: ...)
              .build())

`with_device` is the port's own: the system runs on the card ("cuda",
the default) unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import SlamSystem
from modular_slam_tpu_torch.utils import registry as reg


class SlamBuilder:
    def __init__(self, cfg: Optional[SlamConfig] = None):
        self._cfg = cfg or SlamConfig()
        self._pipeline = "slam"
        self._detector = "orb_grid"
        self._matcher = "hamming_2nn"
        self._pnp = "ransac_3p"
        self._frame_actions: List[Callable] = []
        self._seed = 0
        self._device = "cuda"

    def with_config(self, cfg: SlamConfig) -> "SlamBuilder":
        self._cfg = cfg
        return self

    def with_pipeline(self, name: str) -> "SlamBuilder":
        self._pipeline = name
        return self

    def with_device(self, device) -> "SlamBuilder":
        self._device = device
        return self

    def with_detector(self, name: str) -> "SlamBuilder":
        if name not in reg.available("detector"):
            raise KeyError(f"unknown detector {name!r}")
        self._detector = name
        return self

    def with_matcher(self, name: str) -> "SlamBuilder":
        if name not in reg.available("matcher"):
            raise KeyError(f"unknown matcher {name!r}")
        self._matcher = name
        return self

    def with_pnp(self, name: str) -> "SlamBuilder":
        if name not in reg.available("pnp"):
            raise KeyError(f"unknown pnp {name!r}")
        self._pnp = name
        return self

    def with_seed(self, seed: int) -> "SlamBuilder":
        self._seed = seed
        return self

    def on_frame(self, fn: Callable) -> "SlamBuilder":
        """Frame observer: fn(timestamp, pose, result)."""
        self._frame_actions.append(fn)
        return self

    def build(self) -> SlamSystem:
        from modular_slam_tpu_torch.models.pipelines import make_pipeline

        system = make_pipeline(
            self._pipeline, self._cfg, device=self._device, seed=self._seed,
            component_names={"detector": self._detector,
                             "matcher": self._matcher, "pnp": self._pnp})
        for fn in self._frame_actions:
            system.register_frame_observer(fn)
        return system
