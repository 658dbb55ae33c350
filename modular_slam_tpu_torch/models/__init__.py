from modular_slam_tpu_torch.models.pipelines import (  # noqa: F401
    PIPELINES,
    make_pipeline,
    odometry_pipeline,
)
