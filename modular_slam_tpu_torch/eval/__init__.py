"""Evaluation: numpy-only synthetic scenes with exact ground truth, ATE."""

from modular_slam_tpu_torch.eval.ate import (  # noqa: F401
    align_umeyama,
    ate_rmse,
)
from modular_slam_tpu_torch.eval.synthetic import (  # noqa: F401
    PlaneSceneGenerator,
)
