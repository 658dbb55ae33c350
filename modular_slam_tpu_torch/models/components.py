"""Injected component set (counterpart of
modular_slam_tpu/models/components.py): the detector, matcher and PnP
solver that the engine step (engine.make_slam_step / make_slam_scan) and
the tracker (frontend.tracker.track_frame) call through, chosen by
registry name.

Contracts (tensors on the engine's device, static shapes, masked):
  detect(gray [H,W], depth [H,W]) -> Features
  match(q_desc_pm1 [N,256], q_valid [N], lm_desc [L,256], lm_mask [L])
      -> Matches                        (raw; the tracker dedupes)
  pnp(pts_world [N,3], uv [N,2], pts_cam [N,3], valid [N],
      init_pose, key) -> PnpResult

`key` is the frame's PRNG key (utils/prng.py), or a stand-in for it
(ops/pnp.py: `prng.Uniforms`, or a `Sampler` that draws the triplets).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.utils import registry as reg

DEFAULT_NAMES: Dict[str, str] = {
    "detector": "orb_grid",
    "matcher": "hamming_2nn",
    "pnp": "ransac_3p",
}


class Components(NamedTuple):
    detect: Callable
    match: Callable
    pnp: Callable
    names: Dict[str, str]


def build_components(cfg: SlamConfig,
                     names: Optional[Dict[str, str]] = None) -> Components:
    """Instantiate the selected detector, matcher and pnp from the
    registry.  `names` maps component kind -> registry name; kinds left
    out take the defaults.  Each factory is called with the full config."""
    picked = dict(DEFAULT_NAMES)
    if names:
        unknown = set(names) - set(DEFAULT_NAMES)
        if unknown:
            raise KeyError(
                f"unknown component kinds {sorted(unknown)}; "
                f"injectable kinds: {sorted(DEFAULT_NAMES)}")
        picked.update(names)
    return Components(
        detect=reg.create("detector", picked["detector"], cfg),
        match=reg.create("matcher", picked["matcher"], cfg),
        pnp=reg.create("pnp", picked["pnp"], cfg),
        names=picked,
    )
