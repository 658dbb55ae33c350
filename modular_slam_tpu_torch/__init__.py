"""modular_slam_tpu_torch — the PyTorch/CUDA port of modular_slam_tpu.

The module layout mirrors the JAX package (`modular_slam_tpu/`), which
stays the reference: every module here has its counterpart at the same
path there, and `tests/test_torch_*.py` hold the two against each other.

This package imports `torch` and never `jax`, and nothing of the JAX
package: `config.py` is a copy of the JAX package's dataclasses, held
equal to them by a test.

Ported so far: the per-frame odometry path (detect -> Hamming 2-NN ->
RANSAC-PnP -> map arena) and the bundle-adjustment backend (`backend/`),
i.e. the `odometry` and `slam` presets.  Both of the JAX package's Pallas
kernels run here as hand-written CUDA for Hopper (`csrc/`); on CPU tensors
their plain PyTorch versions run instead.

Float32 matrix products and convolutions run in full float32: the JAX
path asks for `Precision.HIGHEST` (ops/brief.py, ops/blur.py), TF32 would
round the blur that feeds the uint8 BRIEF comparisons, and the BA normal
equations need the digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
