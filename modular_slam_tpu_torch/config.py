"""Static configuration — a copy of modular_slam_tpu/config.py.

The port imports nothing of the JAX package, so it carries the same
frozen dataclasses here, without their comments: the JAX file documents
where every default comes from.  `tests/test_torch_types.py` holds every
field of both equal, so the two cannot drift apart.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    depth_factor: float = 1.0 / 5000.0
    width: int = 640
    height: int = 480


def tum_camera_config() -> CameraConfig:
    return CameraConfig()


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20
    fast_threshold_low: int = 7
    cell_size: int = 32
    border: int = 19
    max_keypoints: int = 512
    max_per_cell: int = 1
    ic_patch_radius: int = 15
    blur_ksize: int = 7
    blur_sigma: float = 2.0


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    lowe_ratio: float = 0.7
    max_hamming: int = 256


@dataclasses.dataclass(frozen=True)
class PnpConfig:
    n_hypotheses: int = 128
    inlier_threshold_px: float = 5.0
    refine_iters: int = 10
    min_points: int = 4
    depth_weight: float = 0.25
    depth_inlier_m: float = 0.25


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    min_matched_points: int = 10
    new_keyframe_min_inliers: int = 30
    max_kf_interval: int = 30
    new_keyframe_inlier_ratio: float = 0.15
    better_keyframe_landmarks: int = 60
    new_landmark_max_depth: float = 3.0
    covis_depth_tracking: int = 2
    covis_depth_better_kf: int = 5


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_keyframes: int = 256
    max_landmarks: int = 16384
    max_observations: int = 131072
    descriptor_bits: int = 256
    highwater: float = 0.9
    kf_evict_target: float = 0.75
    cull_min_obs: int = 2
    cull_protect_recent: int = 256
    fusion_max_dist_m: float = 0.10
    fusion_max_hamming: int = 40


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    max_iterations: int = 20
    cg_iters: int = 40
    gba_max_iterations: int = 10
    gba_cg_iters: int = 24
    gba_early_stop_rtol: float = 1e-3
    local_window_depth: int = 1
    local_max_iterations: int = 8
    local_kf_cap: int = 16
    local_lm_cap: int = 2048
    local_obs_cap: int = 6144
    local_residual: str = "p2p"
    global_residual: str = "rgbd"
    outlier_threshold_m: float = 0.15
    init_lambda: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    min_obs_per_landmark: int = 2
    huber_delta: float = 0.1
    huber_delta_px: float = 2.0
    depth_weight: float = 0.25


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    vocab_size: int = 1024
    top_k: int = 3
    min_score: float = 0.15
    min_gap_keyframes: int = 20
    min_gap_floor: int = 3
    min_gap_fraction: float = 0.3
    max_covis_overlap: int = 15
    min_inliers: int = 25
    closure_cooldown_keyframes: int = 3
    pgo_iterations: int = 20
    pgo_cg_iters: int = 32
    global_ba_on_loop: bool = True
    post_fuse_polish: bool = True
    deferred_polish_burst: int = 3


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    detector: DetectorConfig = dataclasses.field(default_factory=DetectorConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    pnp: PnpConfig = dataclasses.field(default_factory=PnpConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config(height: int = 120, width: int = 160) -> SlamConfig:
    """Small capacities for fast CPU tests."""
    return SlamConfig(
        camera=CameraConfig(fx=100.0, fy=100.0, cx=width / 2 - 0.5,
                            cy=height / 2 - 0.5, width=width, height=height),
        detector=DetectorConfig(n_levels=3, max_keypoints=128, border=19),
        map=MapConfig(max_keyframes=16, max_landmarks=512,
                      max_observations=2048),
        pnp=PnpConfig(n_hypotheses=32),
    )
