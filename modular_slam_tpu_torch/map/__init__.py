from modular_slam_tpu_torch.map.arena import (  # noqa: F401
    MapArena,
    add_keyframe,
    add_landmarks,
    add_observations,
    empty_arena,
    khop_keyframes,
    visible_landmarks,
)
