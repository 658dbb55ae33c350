"""Device grids, the sharded bundle adjustments on `torch.distributed`,
and multi-sequence data parallelism (counterpart of
modular_slam_tpu/parallel/)."""

from modular_slam_tpu_torch.parallel.mesh import (  # noqa: F401
    make_kf_mesh,
    make_mesh,
    obs_sharded_specs,
)
from modular_slam_tpu_torch.parallel.sharded_ba import (  # noqa: F401
    make_sharded_global_ba,
)
from modular_slam_tpu_torch.parallel.kf_sharded_ba import (  # noqa: F401
    make_kf_sharded_global_ba,
)
from modular_slam_tpu_torch.parallel.halo_ba import (  # noqa: F401
    halo_comms_table,
    make_halo_sharded_global_ba,
)
from modular_slam_tpu_torch.parallel.dp import (  # noqa: F401
    make_batch_slam_scan,
    make_batch_slam_step,
)
