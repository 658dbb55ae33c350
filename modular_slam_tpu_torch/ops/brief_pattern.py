"""Deterministic BRIEF-256 sampling pattern — a numpy-only copy of
modular_slam_tpu/ops/brief_pattern.py (the JAX package's `ops/__init__`
imports jax, so the port cannot import it from there).  A test holds
`PATTERN` equal to the JAX package's.

Classic BRIEF G-II pattern: both endpoints i.i.d. N(0, (31/5)^2), rounded
and clipped to [-13, 13], from a fixed seed.
"""

from __future__ import annotations

import numpy as np

_PATCH_RADIUS = 13  # endpoints within [-13, 13]; rotated radius <= 18.4
_SEED = 0x0B5E55ED


def make_pattern(n_pairs: int = 256, seed: int = _SEED) -> np.ndarray:
    """[n_pairs, 4] int32: (x1, y1, x2, y2) offsets from the patch center."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(n_pairs, 4))
    pts = np.clip(np.round(pts), -_PATCH_RADIUS, _PATCH_RADIUS).astype(np.int32)
    # avoid degenerate pairs (identical endpoints): nudge x2 by +1
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] = np.clip(pts[same, 2] + 1, -_PATCH_RADIUS, _PATCH_RADIUS)
    return pts


PATTERN = make_pattern()
