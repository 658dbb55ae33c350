"""The port's detector stages (modular_slam_tpu_torch/ops/*) against the
JAX package.

Exact: the BRIEF pattern copy, the per-level score -> NMS -> fallback ->
candidates path given the JAX pyramid levels, patch extraction on valid
rows, and BRIEF bits given the same blurred patches and angles.

Within a tolerance, because float32 sums run in another order in the two
frameworks (and atan2 comes from another math library): pyramid levels
(1e-3), the patch blur (5e-4 on 0..255 values), IC angles (2e-3 rad).
End to end, `detect` on a rendered frame gives the same valid keypoints
(scores within 1e-3), and descriptors that agree on at least 99.5 % of
the bits: an ulp in the blur can move a value across a uint8 rounding
edge.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import DetectorConfig, tiny_test_config
from modular_slam_tpu.ops import blur as jblur
from modular_slam_tpu.ops import brief as jbrief
from modular_slam_tpu.ops import brief_pattern as jpattern
from modular_slam_tpu.ops import detector as jdet
from modular_slam_tpu.ops import orient as jorient
from modular_slam_tpu.ops import pyramid as jpyr
from modular_slam_tpu.ops.fast import border_mask as jborder
from modular_slam_tpu.ops.fast import fast_score as jfast_score
from modular_slam_tpu.ops.fast import nms3x3 as jnms
from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
from modular_slam_tpu_torch.io.tum import rgb_to_luma
from modular_slam_tpu_torch.ops import blur as tblur
from modular_slam_tpu_torch.ops import brief as tbrief
from modular_slam_tpu_torch.ops import brief_pattern as tpattern
from modular_slam_tpu_torch.ops import detector as tdet
from modular_slam_tpu_torch.ops import orient as torient
from modular_slam_tpu_torch.ops import pyramid as tpyr
from modular_slam_tpu_torch.ops.fast import border_mask, fast_score, nms3x3


def _frame(cfg, seed=3):
    gen = PlaneSceneGenerator(cfg.camera, seed=seed, texture_ppm=100.0)
    pose = gen.trajectory(2, step_t=(0.01, 0.004, 0.0),
                          step_rot=(0.01, 0.02, 0.03))[1]
    rgb, depth = gen.render(pose)
    return rgb, depth


def test_brief_pattern_is_the_jax_pattern():
    np.testing.assert_array_equal(tpattern.PATTERN, jpattern.PATTERN)
    sel = jbrief._bin_selector_np(tbrief.N_ANGLE_BINS)
    np.testing.assert_array_equal(
        tbrief._bin_sample_index_np(tbrief.N_ANGLE_BINS), sel.argmax(axis=1))


def test_luma_matches_jax_bitwise():
    from modular_slam_tpu.io.tum import frame_to_device

    rgb = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
    ref = np.asarray(frame_to_device(rgb, np.zeros((48, 64)), 0.0).gray)
    np.testing.assert_array_equal(rgb_to_luma(torch.from_numpy(rgb)).numpy(),
                                  ref)


@pytest.mark.parametrize("hw", [(120, 160), (240, 320)])
def test_pyramid_levels_close(hw):
    cfg = DetectorConfig()
    img = np.random.default_rng(1).uniform(0, 255, hw).astype(np.float32)
    got = tpyr.build_pyramid(torch.from_numpy(img), cfg)
    ref = jpyr.build_pyramid(jnp.asarray(img), cfg)
    assert len(got) == cfg.n_levels
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("hw", [(120, 160), (240, 320), (480, 640)])
def test_pyramid_differences_are_sample_rounding(hw):
    """What sets the pyramid's differences from `jax.image.resize`.  No
    edge rule: every sample position (i + 0.5) * in / out - 0.5 lies
    strictly inside [0, in - 1], so both resizers blend the same two
    pixels with weights that sum to 1 and JAX's renormalisation of
    one-sided weights never applies.  The differences above 1e-4 lie on
    a single row or column per level — one sample position that XLA's
    fused multiply-add and ATen's float32 arithmetic round to neighbouring
    floats (a level resized from such a level inherits it) — and the rest
    of the level is within 1e-4."""
    cfg = DetectorConfig()
    shapes = tpyr.pyramid_shapes(*hw, cfg)
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        for n_in, n_out in ((h0, h1), (w0, w1)):
            pos = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
            assert pos.min() > 0.0 and pos.max() < n_in - 1
    img = np.random.default_rng(1).uniform(0, 255, hw).astype(np.float32)
    got = tpyr.build_pyramid(torch.from_numpy(img), cfg)
    ref = jpyr.build_pyramid(jnp.asarray(img), cfg)
    for g, r in zip(got, ref):
        big = np.argwhere(np.abs(g.numpy() - np.asarray(r)) > 1e-4)
        assert len(set(big[:, 0])) <= 1 or len(set(big[:, 1])) <= 1, big


def test_candidates_exact_given_jax_levels():
    cfg = tiny_test_config().detector
    rgb, _ = _frame(tiny_test_config())
    gray = jnp.asarray(rgb[..., 0].astype(np.float32))
    for img in jpyr.build_pyramid(gray, cfg):
        h, w = img.shape
        s = jnms(jfast_score(img)) * jborder(h, w, cfg.border, img.dtype)
        s = jnp.where(s > float(cfg.fast_threshold_low), s, 0.0)
        s = jdet._cell_threshold_fallback(s, cfg.cell_size,
                                          float(cfg.fast_threshold))
        yx_ref, resp_ref = jdet._cell_candidates(s, cfg.cell_size, 1)

        t = torch.from_numpy(np.array(img))
        ts = nms3x3(fast_score(t)) * border_mask(h, w, cfg.border)
        ts = torch.where(ts > float(cfg.fast_threshold_low), ts,
                         torch.zeros_like(ts))
        ts = tdet._cell_threshold_fallback(ts, cfg.cell_size,
                                           float(cfg.fast_threshold))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
        yx, resp = tdet._cell_candidates(ts, cfg.cell_size, 1)
        np.testing.assert_array_equal(yx.numpy(), np.asarray(yx_ref))
        np.testing.assert_array_equal(resp.numpy(), np.asarray(resp_ref))


def test_cell_candidates_top2_tie_order():
    """Ties at 0 everywhere: lax.top_k and the stable sort both keep the
    lowest index first."""
    s = np.zeros((64, 64), np.float32)
    s[5, 7] = s[9, 1] = 3.0
    yx_ref, resp_ref = jdet._cell_candidates(jnp.asarray(s), 32, 3)
    yx, resp = tdet._cell_candidates(torch.from_numpy(s), 32, 3)
    np.testing.assert_array_equal(yx.numpy(), np.asarray(yx_ref))
    np.testing.assert_array_equal(resp.numpy(), np.asarray(resp_ref))


def _patch_inputs(n=64, seed=4):
    rng = np.random.default_rng(seed)
    atlas = rng.uniform(0, 255, (3, 90, 100)).astype(np.float32)
    level = rng.integers(0, 3, n).astype(np.int32)
    yx = np.stack([rng.integers(21, 69, n), rng.integers(21, 79, n)],
                  -1).astype(np.int32)
    return atlas, level, yx


def test_extract_patches_exact():
    atlas, level, yx = _patch_inputs()
    ref = np.asarray(jbrief.extract_patches_matmul(
        jnp.asarray(atlas), jnp.asarray(level), jnp.asarray(yx), patch=43))
    got = tbrief.extract_patches(torch.from_numpy(atlas),
                                 torch.from_numpy(level),
                                 torch.from_numpy(yx), patch=43)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_angle_blur_close_and_brief_exact():
    atlas, level, yx = _patch_inputs()
    p = np.array(jbrief.extract_patches_matmul(
        jnp.asarray(atlas), jnp.asarray(level), jnp.asarray(yx),
        patch=43)).reshape(-1, 43, 43)
    ang_ref = np.asarray(jorient.ic_angle_from_patches(jnp.asarray(p)))
    ang = torient.ic_angle_from_patches(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(ang, ang_ref, rtol=0, atol=2e-3)
    bp_ref = np.array(jblur.blur_patches(jnp.asarray(p)))
    bp = tblur.blur_patches(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(bp, bp_ref, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(tblur.gaussian_kernel_1d(7, 2.0),
                                  jblur.gaussian_kernel_1d(7, 2.0))
    # BRIEF: exact given the same blurred patches and angles, including
    # angles on bin edges
    flat = bp_ref.reshape(len(p), -1)
    ang_ref = ang_ref.copy()
    ang_ref[:8] = (np.arange(8) + 0.5) * (2 * np.pi / 32)
    bits_ref = np.asarray(jbrief.brief_matmul_from_patches(
        jnp.asarray(flat), jnp.asarray(ang_ref)))
    bits = tbrief.brief_from_patches(torch.from_numpy(flat),
                                     torch.from_numpy(ang_ref)).numpy()
    np.testing.assert_array_equal(bits, bits_ref)


def test_detect_on_rendered_frame():
    cfg = tiny_test_config()
    rgb, depth = _frame(cfg)
    gray = rgb_to_luma(torch.from_numpy(rgb))
    got = tdet.detect(gray, torch.from_numpy(depth), cfg.detector)
    ref = jax.jit(lambda g, d: jdet.detect(g, d, cfg.detector))(
        jnp.asarray(gray.numpy()), jnp.asarray(depth))
    v = np.asarray(ref.keypoints.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(got.keypoints.valid.numpy(), v)
    for f in ("uv", "level", "depth"):
        np.testing.assert_array_equal(
            getattr(got.keypoints, f).numpy()[v],
            np.asarray(getattr(ref.keypoints, f))[v])
    # scores of resized levels carry the pyramid's rounding difference
    np.testing.assert_allclose(got.keypoints.response.numpy()[v],
                               np.asarray(ref.keypoints.response)[v],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.keypoints.angle.numpy()[v],
                               np.asarray(ref.keypoints.angle)[v],
                               rtol=0, atol=2e-3)
    bits = got.descriptors.unpacked.numpy()[v]
    bits_ref = np.asarray(ref.descriptors.unpacked)[v]
    assert (bits == bits_ref).mean() >= 0.995
    packed = got.descriptors.packed.numpy()[v]
    assert packed.dtype == np.int32
