from modular_slam_tpu_torch.backend.ba import (  # noqa: F401
    ba_solve,
    make_local_ba,
    make_global_ba,
    BAStats,
)
