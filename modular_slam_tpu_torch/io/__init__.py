from modular_slam_tpu_torch.io.associate import associate  # noqa: F401
from modular_slam_tpu_torch.io.trajectory import (  # noqa: F401
    KittiTrajectoryWriter,
    TumTrajectoryWriter,
    read_tum_trajectory,
    trajectory_array,
)
from modular_slam_tpu_torch.io.tum import (  # noqa: F401
    TumRgbdDataset,
    frame_to_device,
    load_depth,
    load_rgb,
)
