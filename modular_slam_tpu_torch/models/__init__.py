from modular_slam_tpu_torch.models.pipelines import (  # noqa: F401
    PIPELINES,
    full_slam_pipeline,
    make_pipeline,
    odometry_pipeline,
    slam_pipeline,
)
from modular_slam_tpu_torch.models.builder import SlamBuilder  # noqa: F401
