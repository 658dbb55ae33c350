from modular_slam_tpu_torch.io.trajectory import (  # noqa: F401
    TumTrajectoryWriter,
    trajectory_array,
)
from modular_slam_tpu_torch.io.tum import frame_to_device  # noqa: F401
