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

The image-domain reference functions: `gaussian_blur` within 1e-4 on
0..255 images, `moment_maps` within 2e-4 of the map's largest moment at
interior pixels (and, as the JAX test holds it, within rtol 2e-4 of the
patch oracle at its four pixels), `ic_angle` within 3e-4 rad, and
`rotated_offsets`, `brief_descriptors`, `brief_from_atlas` and
`brief_matmul` bit-equal.  `detect_until` at each cut: the selection
exact, the atlas within 1e-3, angles within 3e-4 rad and bits equal on
the valid rows.
"""

import cv2
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


def _blurred_noise(h, w, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w))
    return cv2.GaussianBlur(img.astype(np.float32), (5, 5), 1.0)


@pytest.mark.parametrize("hw", [(64, 80), (61, 83)])
def test_gaussian_blur_matches_jax(hw):
    img = _blurred_noise(*hw, seed=hw[1])
    got = tblur.gaussian_blur(torch.from_numpy(img), 7, 2.0).numpy()
    ref = np.asarray(jblur.gaussian_blur(jnp.asarray(img), 7, 2.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, cv2.GaussianBlur(
        img, (7, 7), 2.0, borderType=cv2.BORDER_REFLECT_101), atol=1e-2)


def test_moment_maps_and_ic_angle_match_jax():
    r = torient.IC_RADIUS
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    mm = torient.moment_maps(torch.from_numpy(img)).numpy()
    ref = np.asarray(jax.jit(jorient.moment_maps)(jnp.asarray(img)))
    assert mm.shape == (2, 96, 128)
    # the rolls' wrap fringe (radius + 1 pixels) holds no moment
    inner = (slice(None), slice(r + 1, -r - 1), slice(r + 1, -r - 1))
    scale = np.abs(ref[inner]).max()
    np.testing.assert_allclose(mm[inner], ref[inner], rtol=0,
                               atol=2e-4 * scale)
    mask = torient._mask_np(r)
    np.testing.assert_array_equal(mask, jorient._mask_np(r))
    coords = np.arange(-r, r + 1, dtype=np.float32)
    for (y, x) in [(20, 20), (48, 64), (70, 100), (19, 108)]:
        patch = img[y - r:y + r + 1, x - r:x + r + 1] * mask
        np.testing.assert_allclose(mm[0, y, x],
                                   float((patch * coords[None, :]).sum()),
                                   rtol=2e-4)
        np.testing.assert_allclose(mm[1, y, x],
                                   float((patch * coords[:, None]).sum()),
                                   rtol=2e-4)

    yx = np.stack([rng.integers(r, 96 - r, 200), rng.integers(r, 128 - r,
                                                             200)], -1)
    yx = yx.astype(np.int32)
    ang = torient.ic_angle(torch.from_numpy(img), torch.from_numpy(yx))
    ang_ref = np.asarray(jorient.ic_angle(jnp.asarray(img), jnp.asarray(yx)))
    np.testing.assert_allclose(ang.numpy(), ang_ref, rtol=0, atol=3e-4)
    # starts clamp to the image, as the JAX gather's
    edge = np.array([[0, 0], [95, 127], [3, 120]], np.int32)
    np.testing.assert_array_equal(
        torient.gather_patches(torch.from_numpy(img),
                               torch.from_numpy(edge), 31).numpy(),
        np.asarray(jorient.gather_patches(jnp.asarray(img),
                                          jnp.asarray(edge), 31)))


def _smooth_atlas(rng):
    """A smooth [3, 120, 156] atlas (blurred-image statistics), as the JAX
    package's test of `brief_matmul` builds it."""
    import scipy.ndimage as ndi

    base = rng.uniform(0, 255, (3, 40, 52))
    atlas = np.stack([ndi.zoom(b, 3.0, order=1) for b in base])
    return atlas[:, :120, :156].astype(np.float32)


def test_continuous_rotation_brief_matches_jax():
    rng = np.random.default_rng(11)
    ang = rng.uniform(-np.pi, np.pi, 96).astype(np.float32)
    for got, ref in zip(tbrief.rotated_offsets(torch.from_numpy(ang)),
                        jbrief.rotated_offsets(jnp.asarray(ang))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    atlas = _smooth_atlas(rng)
    yx = np.stack([rng.integers(20, 100, 96), rng.integers(20, 136, 96)],
                  -1).astype(np.int32)
    lvl = rng.integers(0, 3, 96).astype(np.int32)
    bits = tbrief.brief_from_atlas(*map(torch.from_numpy,
                                        (atlas, lvl, yx, ang)))
    ref = jbrief.brief_from_atlas(*map(jnp.asarray, (atlas, lvl, yx, ang)))
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref))
    one = tbrief.brief_descriptors(torch.from_numpy(atlas[1]),
                                   torch.from_numpy(yx),
                                   torch.from_numpy(ang))
    np.testing.assert_array_equal(one.numpy(), np.asarray(
        jbrief.brief_descriptors(jnp.asarray(atlas[1]), jnp.asarray(yx),
                                 jnp.asarray(ang))))


def test_brief_from_atlas_off_the_atlas_matches_jax():
    """Keypoints in the corners of a small atlas: flat sample indices in
    [-n, 0) wrap, as JAX's `jnp.take` does, and those below -n or at n and
    above read NaN there, so their bits are 0; the bits are JAX's exactly."""
    rng = np.random.default_rng(12)
    atlas = rng.uniform(0, 255, (2, 5, 6)).astype(np.float32)
    n = atlas.size
    corners = [(0, 0), (0, 5), (4, 0), (4, 5), (2, 3)]
    yx = np.array([c for c in corners for _ in range(2)] * 4, np.int32)
    lvl = np.repeat(np.arange(2, dtype=np.int32), len(yx) // 2)
    ang = rng.uniform(-np.pi, np.pi, len(yx)).astype(np.float32)
    ry1, rx1, ry2, rx2 = (x.numpy() for x in
                          tbrief.rotated_offsets(torch.from_numpy(ang)))
    base = (lvl.astype(np.int64) * atlas.shape[1] * atlas.shape[2])[:, None]
    idx = np.concatenate([
        base + (yx[:, :1] + ry) * atlas.shape[2] + yx[:, 1:] + rx
        for ry, rx in ((ry1, rx1), (ry2, rx2))])
    assert ((idx >= -n) & (idx < 0)).sum() > 100        # wrap
    assert (idx < -n).sum() > 100 and (idx >= n).sum() > 100  # NaN in JAX
    assert ((idx >= 0) & (idx < n)).sum() > 100
    bits = tbrief.brief_from_atlas(*map(torch.from_numpy,
                                        (atlas, lvl, yx, ang)))
    ref = jbrief.brief_from_atlas(*map(jnp.asarray, (atlas, lvl, yx, ang)))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref))
    assert 0 < bits.numpy().mean() < 0.5


def test_keypoints_capacity_matches_jax():
    """`Keypoints.capacity`, N as a Python int, as JAX's on its detect
    output (read from its shapes)."""
    cfg = tiny_test_config()
    rgb, depth = _frame(cfg)
    gray = rgb_to_luma(torch.from_numpy(rgb))
    got = tdet.detect(gray, torch.from_numpy(depth), cfg.detector)
    ref = jax.eval_shape(lambda g, d: jdet.detect(g, d, cfg.detector),
                         jnp.asarray(gray.numpy()), jnp.asarray(depth))
    assert type(got.keypoints.capacity) is int
    assert got.keypoints.capacity == ref.keypoints.capacity == \
        cfg.detector.max_keypoints


def test_brief_matmul_matches_gather_oracle():
    """The JAX package's test through the port: the binned BRIEF is
    bit-exact against the continuous gather on the rounded atlas at
    bin-centre angles, and close to it elsewhere; and equal to the JAX
    `brief_matmul`."""
    rng = np.random.default_rng(7)
    atlas = _smooth_atlas(rng)
    N = 96
    yx = np.stack([rng.integers(20, 100, N), rng.integers(20, 136, N)],
                  -1).astype(np.int32)
    lvl = rng.integers(0, 3, N).astype(np.int32)
    b = rng.integers(0, tbrief.N_ANGLE_BINS, N)
    ang = (2 * np.pi * b / tbrief.N_ANGLE_BINS).astype(np.float32)
    t_atlas, t_lvl, t_yx = map(torch.from_numpy, (atlas, lvl, yx))
    bits_g = tbrief.brief_from_atlas(torch.round(t_atlas), t_lvl, t_yx,
                                     torch.from_numpy(ang)).numpy()
    bits_m = tbrief.brief_matmul(t_atlas, t_lvl, t_yx,
                                 torch.from_numpy(ang)).numpy()
    assert (bits_g == bits_m).all(), int((bits_g != bits_m).sum())
    ang2 = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    bg = tbrief.brief_from_atlas(torch.round(t_atlas), t_lvl, t_yx,
                                 torch.from_numpy(ang2)).numpy()
    bm = tbrief.brief_matmul(t_atlas, t_lvl, t_yx,
                             torch.from_numpy(ang2)).numpy()
    assert (bg != bm).sum(1).mean() < 40
    ref = jbrief.brief_matmul(*map(jnp.asarray, (atlas, lvl, yx, ang2)))
    np.testing.assert_array_equal(bm, np.asarray(ref))


def test_descriptor_rotation_invariance():
    """The JAX package's rotation check through the port: rotating the
    image 30 degrees changes fewer than 60 of a strong corner's 256 bits
    (steered BRIEF + IC angle)."""
    rng = np.random.default_rng(3)
    img = np.full((240, 240), 128.0, np.float32)
    for y, x in zip(rng.integers(20, 220, 120), rng.integers(20, 220, 120)):
        sz = int(rng.integers(2, 6))
        img[y:y + sz, x:x + sz] = float(rng.uniform(0, 255))
    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    M = cv2.getRotationMatrix2D((120, 120), 30.0, 1.0)
    rot = cv2.warpAffine(img, M, (240, 240), flags=cv2.INTER_LINEAR,
                         borderValue=128.0)
    s = (fast_score(torch.from_numpy(img))
         * border_mask(240, 240, 40)).numpy()
    y, x = np.unravel_index(s.argmax(), s.shape)
    xr, yr = (int(round(c)) for c in M @ np.array([x, y, 1.0]))

    def desc_at(image, yy, xx):
        t = torch.from_numpy(image)
        yx = torch.tensor([[yy, xx]], dtype=torch.int32)
        return tbrief.brief_descriptors(tblur.gaussian_blur(t, 7, 2.0), yx,
                                        torient.ic_angle(t, yx))[0]

    hamming = int((desc_at(img, y, x) != desc_at(rot, yr, xr)).sum())
    assert hamming < 60, f"rotation changed {hamming}/256 bits"


@pytest.mark.parametrize("cut", tdet.CUTS)
def test_detect_until_matches_jax(cut):
    cfg = tiny_test_config()
    rgb, depth = _frame(cfg)
    gray = rgb_to_luma(torch.from_numpy(rgb))
    got = tdet.detect_until(gray, torch.from_numpy(depth), cfg.detector, cut)
    ref = jax.jit(lambda g, d: jdet.detect_until(g, d, cfg.detector, cut))(
        jnp.asarray(gray.numpy()), jnp.asarray(depth))
    got = [x.numpy() for x in got]
    ref = [np.asarray(x) for x in ref]
    assert [x.shape for x in got] == [x.shape for x in ref]
    if cut == "full":
        v = tdet.detect_until(gray, torch.from_numpy(depth), cfg.detector,
                              "select")[2].numpy() > 0
        uv, ang, dep, pm1 = got
        np.testing.assert_array_equal(uv[v], ref[0][v])
        np.testing.assert_array_equal(dep[v], ref[2][v])
        np.testing.assert_allclose(ang[v], ref[1][v], rtol=0, atol=3e-4)
        np.testing.assert_array_equal(pm1[v], ref[3][v])
        return
    yx, lvl, resp = got[:3]
    np.testing.assert_array_equal(yx, ref[0])
    np.testing.assert_array_equal(lvl, ref[1])
    v = resp > 0
    assert v.sum() > 10
    np.testing.assert_array_equal(v, ref[2] > 0)
    np.testing.assert_allclose(resp, ref[2], rtol=0, atol=1e-3)
    if cut == "atlas":
        np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1e-3)
    if cut in ("orient", "brief"):
        np.testing.assert_allclose(got[3][v], ref[3][v], rtol=0, atol=3e-4)
    if cut == "brief":
        step = np.float32(2 * np.pi / tbrief.N_ANGLE_BINS)
        same_bin = (np.round(got[3][v] / step) == np.round(ref[3][v] / step))
        assert same_bin.all()
        np.testing.assert_array_equal(got[4][v][same_bin],
                                      ref[4][v][same_bin])
