"""Device grids and multi-sequence data parallelism (counterpart of
modular_slam_tpu/parallel/; the sharded bundle adjustment is not ported
yet)."""

from modular_slam_tpu_torch.parallel.mesh import (  # noqa: F401
    make_kf_mesh,
    make_mesh,
)
from modular_slam_tpu_torch.parallel.dp import (  # noqa: F401
    make_batch_slam_scan,
    make_batch_slam_step,
)
