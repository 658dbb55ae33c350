"""The port's FAST scoring (modular_slam_tpu_torch/ops/fast.py) against
the JAX package: its Pallas kernel in interpret mode and its XLA
formulation.  On the CPU the port runs the plain version of kernel K1;
the CUDA kernel itself is held against that plain version by
chip_smoke.py on the card."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.ops import fast as jfast
from modular_slam_tpu.ops import fast_pallas as jfp
from modular_slam_tpu_torch.ops import fast as tfast


def _interp(fn):
    from jax.experimental.pallas import tpu as pltpu

    def run(*a):
        with pltpu.force_tpu_interpret_mode():
            return fn(*a)
    return run


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(120, 160), (95, 130)])
def test_fast_score_matches_pallas_and_xla(shape):
    img = _img(shape, 0)
    got = tfast.fast_score(torch.from_numpy(img)).numpy()
    # the XLA formulation wraps at the edges exactly like the port: equal
    # everywhere
    ref = np.asarray(jfast.fast_score(jnp.asarray(img)))
    np.testing.assert_array_equal(got, ref)
    # the Pallas kernel pads instead of wrapping: equal away from 3 px
    pal = np.asarray(_interp(jfp._fast_score_impl)(jnp.asarray(img)))
    b = 3
    np.testing.assert_array_equal(got[b:-b, b:-b], pal[b:-b, b:-b])


def test_fast_score_batch_matches_vmap():
    imgs = _img((3, 64, 130), 1)
    got = tfast.fast_score(torch.from_numpy(imgs)).numpy()
    ref = np.asarray(jax.vmap(jfast.fast_score)(jnp.asarray(imgs)))
    np.testing.assert_array_equal(got, ref)
    pal = np.asarray(_interp(jax.vmap(jfp._fast_score_batchable()))(
        jnp.asarray(imgs)))
    np.testing.assert_array_equal(got[:, 3:-3, 3:-3], pal[:, 3:-3, 3:-3])


def test_fast_score_on_rendered_image_has_corners():
    """Realistic input (ties at 0 everywhere flat): still exact."""
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu.config import tiny_test_config

    gen = PlaneSceneGenerator(tiny_test_config().camera, seed=3,
                              texture_ppm=100.0)
    rgb, _ = gen.render(gen.trajectory(1)[0])
    img = rgb[..., 0].astype(np.float32)
    got = tfast.fast_score(torch.from_numpy(img)).numpy()
    ref = np.asarray(jfast.fast_score(jnp.asarray(img)))
    np.testing.assert_array_equal(got, ref)
    assert (got > 20).sum() > 20


def test_nms3x3_and_border_mask_exact():
    score = np.random.default_rng(2).integers(0, 6, (40, 52)).astype(
        np.float32)  # many ties
    got = tfast.nms3x3(torch.from_numpy(score)).numpy()
    ref = np.asarray(jfast.nms3x3(jnp.asarray(score)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tfast.border_mask(40, 52, 7).numpy(),
        np.asarray(jfast.border_mask(40, 52, 7)))


def test_cpu_tensor_never_reaches_the_kernel():
    from modular_slam_tpu_torch.ops.kernels import FAST_SCORE

    before = FAST_SCORE.launches
    tfast.fast_score(torch.zeros(16, 16))
    assert FAST_SCORE.launches == before
    with pytest.raises(ValueError):
        tfast.fast_score_cuda(torch.zeros(16, 16))
