from modular_slam_tpu_torch.map.arena import (  # noqa: F401
    MapArena,
    add_keyframe,
    add_landmarks,
    add_observations,
    apply_backend_update,
    covis_counts,
    empty_arena,
    khop_keyframes,
    visible_landmarks,
)
