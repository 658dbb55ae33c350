"""Detector, matcher and PnP ops; `kernels` builds the CUDA kernels."""

from modular_slam_tpu_torch.ops.pyramid import (  # noqa: F401
    build_pyramid,
    pyramid_shapes,
)
from modular_slam_tpu_torch.ops.fast import fast_score, nms3x3  # noqa: F401
from modular_slam_tpu_torch.ops.blur import gaussian_blur  # noqa: F401
from modular_slam_tpu_torch.ops.detector import detect  # noqa: F401
from modular_slam_tpu_torch.ops.match import (  # noqa: F401
    hamming_matrix,
    match_descriptors,
)
from modular_slam_tpu_torch.ops.pnp import ransac_pnp  # noqa: F401
