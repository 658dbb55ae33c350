"""modular_slam_tpu_torch — the PyTorch/CUDA port of modular_slam_tpu.

The module layout mirrors the JAX package (`modular_slam_tpu/`), which
stays the reference: every module here has its counterpart at the same
path there, and `tests/test_torch_*.py` hold the two against each other.

This package imports `torch` and never `jax`, and nothing of the JAX
package: `config.py` is a copy of the JAX package's dataclasses, held
equal to them by a test.

Every public name of the JAX package has its counterpart here: the
per-frame odometry path (detect -> Hamming 2-NN -> RANSAC-PnP -> map
arena), the bundle-adjustment backend (`backend/`), and loop closure,
pose-graph optimization, relocalization and the map lifecycle (`loop/`,
`backend/posegraph.py`, `map/lifecycle.py`), i.e. the `odometry`, `slam`
and `full` presets frame by frame and chunk by chunk; the host side: the
component registry (`utils/registry.py`, `models/components.py`,
`models/builder.py`), runtime parameters, checkpoints, the TUM dataset
reader and writer (`io/`, `eval/`) and the command-line runner
(`run.py`); the evaluation driver (`eval/evaluate.py`,
`eval/report.py`); multi-sequence tracking and the sharded bundle
adjustments on `torch.distributed` (`parallel/`); the viewer
(`viewer.py`, `viz/`); and the reference ORB functions, `detect_until`,
`covis_counts` and the other library functions off the engine's path.
Calls bind as in the JAX package: JAX's parameters in JAX's positional
order with JAX's defaults, the port's own (`device`, and a `sampler` that
may draw in place of JAX's stream) after them, keyword-only on the entry
points.  A PRNG key is JAX's, and a seed draws JAX's RANSAC triplets
(`utils/prng.py`).  Both of
the JAX package's Pallas kernels run here as hand-written CUDA for
Hopper (`csrc/`); on CPU tensors their plain PyTorch versions run
instead.

Float32 matrix products and convolutions run in full float32: the JAX
path asks for `Precision.HIGHEST` (ops/brief.py, ops/blur.py), TF32 would
round the blur that feeds the uint8 BRIEF comparisons, and the BA normal
equations need the digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from modular_slam_tpu_torch.config import (  # noqa: E402,F401
    CameraConfig,
    DetectorConfig,
    MatcherConfig,
    PnpConfig,
    TrackerConfig,
    MapConfig,
    BackendConfig,
    LoopConfig,
    SlamConfig,
    tum_camera_config,
)
