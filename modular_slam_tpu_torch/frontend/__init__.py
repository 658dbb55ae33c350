from modular_slam_tpu_torch.frontend.tracker import (  # noqa: F401
    TrackState,
    initial_state,
    track_frame,
)
