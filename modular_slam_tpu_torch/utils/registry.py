"""Component registry (counterpart of modular_slam_tpu/utils/registry.py).

Named factories per component kind: register a factory under
("detector", "my_impl") and any pipeline can select it by name.  A
factory is called with the `SlamConfig` and returns a closure of the
contract in models/components.py.  Third-party packages register through
normal imports or through the "modular_slam_tpu_torch.plugins" entry-point
group (`load_entry_point_plugins`).

Built-ins:

- detector/orb_grid: `ops.detector.detect` (kernel K1 on CUDA tensors);
- matcher/hamming_2nn and matcher/hamming_2nn_pallas:
  `ops.match.match_descriptors` — kernel K2 and its merge on CUDA tensors,
  the plain version on CPU tensors (the JAX package's Pallas matcher);
- matcher/hamming_2nn_xla: `ops.match.match_descriptors_plain`, the
  full-matrix formulation (the JAX package's XLA matcher); it runs only
  when a caller names it;
- pnp/ransac_3p: `ops.pnp.ransac_pnp`;
- data_provider/tum_files and data_provider/realsense.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

_REGISTRY: Dict[Tuple[str, str], Callable[..., Any]] = {}

KINDS = ("detector", "matcher", "pnp", "map", "backend", "loop_detector",
         "relocalizer", "data_provider")

ENTRY_POINT_GROUP = "modular_slam_tpu_torch.plugins"


def register(kind: str, name: str):
    """Decorator: @register("detector", "orb")"""
    if kind not in KINDS:
        raise ValueError(f"unknown component kind {kind!r}; one of {KINDS}")

    def deco(factory):
        _REGISTRY[(kind, name)] = factory
        return factory

    return deco


def create(kind: str, name: str, *args, **kwargs):
    key = (kind, name)
    if key not in _REGISTRY:
        raise KeyError(
            f"no {kind} named {name!r}; available: {available(kind)}")
    return _REGISTRY[key](*args, **kwargs)


def available(kind: str) -> List[str]:
    return sorted(n for (k, n) in _REGISTRY if k == kind)


def load_entry_point_plugins() -> int:
    """Load third-party plugins from the ENTRY_POINT_GROUP entry points
    (each is a callable invoked once to make its register() calls).
    Returns the number loaded."""
    from importlib.metadata import entry_points

    count = 0
    for ep in entry_points(group=ENTRY_POINT_GROUP):
        ep.load()()
        count += 1
    return count


# ---------------------------------------------------------------------------
# built-in components
# ---------------------------------------------------------------------------


def _register_builtins() -> None:
    import numpy as np

    from modular_slam_tpu_torch.geometry.camera import Camera
    from modular_slam_tpu_torch.io.tum import TumRgbdDataset
    from modular_slam_tpu_torch.ops.detector import detect
    from modular_slam_tpu_torch.ops.match import (match_descriptors,
                                                  match_descriptors_plain)
    from modular_slam_tpu_torch.ops.pnp import ransac_pnp
    from modular_slam_tpu_torch.utils.device import upload

    @register("detector", "orb_grid")
    def _orb(cfg):
        return lambda gray, depth: detect(gray, depth, cfg.detector)

    def _k2_matcher(cfg):
        return lambda q, qv, t, tv: match_descriptors(q, qv, t, tv,
                                                      cfg.matcher)

    register("matcher", "hamming_2nn")(_k2_matcher)
    register("matcher", "hamming_2nn_pallas")(_k2_matcher)

    @register("matcher", "hamming_2nn_xla")
    def _matcher_plain(cfg):
        return lambda q, qv, t, tv: match_descriptors_plain(q, qv, t, tv,
                                                            cfg.matcher)

    @register("pnp", "ransac_3p")
    def _pnp(cfg):
        cams: Dict[Any, Camera] = {}

        def camera(device):
            # made once per device, through pinned memory: no host sync
            if device not in cams:
                c = cfg.camera
                cams[device] = Camera(
                    *(upload(np.asarray(v, np.float32), device).reshape(())
                      for v in (c.fx, c.fy, c.cx, c.cy)),
                    width=c.width, height=c.height)
            return cams[device]

        return lambda pw, uv, pc, v, init, key: ransac_pnp(
            camera(pw.device), pw, uv, pc, v, init, key, cfg.pnp)

    @register("data_provider", "tum_files")
    def _tum(cfg, root):
        return TumRgbdDataset(root, cfg.camera)

    @register("data_provider", "realsense")
    def _realsense(cfg, root=None, **kw):
        # a live camera reports its own intrinsics in `provider.camera`:
        # rebuild the config from it (cfg.replace(camera=provider.camera))
        # before building camera-dependent components
        from modular_slam_tpu_torch.io.camera import LiveRgbdCamera

        return LiveRgbdCamera(width=cfg.camera.width,
                              height=cfg.camera.height, **kw)


_register_builtins()
