from modular_slam_tpu_torch.geometry.camera import (  # noqa: F401
    Camera,
    backproject,
    camera_from_config,
    project,
)
from modular_slam_tpu_torch.geometry.se3 import (  # noqa: F401
    Pose,
    identity_pose,
    matrix_to_quat,
    pose_apply,
    pose_compose,
    pose_inverse,
    pose_retract,
    pose_to_matrix,
    quat_to_matrix,
    se3_exp,
    se3_log,
    so3_log,
)
