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
    tfast.fast_score_levels([torch.zeros(16, 16), torch.zeros(9, 7)])
    assert FAST_SCORE.launches == before
    with pytest.raises(ValueError):
        tfast.fast_score_cuda(torch.zeros(16, 16))
    with pytest.raises(ValueError):
        tfast.fast_score_levels_cuda([torch.zeros(16, 16)])


@pytest.mark.parametrize("hw", [(120, 160), (97, 131)])
def test_fast_score_levels_equal_jax_per_level(hw):
    """The detector's one call for all levels equals the JAX fast_score
    of each level of a small frame's pyramid, exactly."""
    from modular_slam_tpu_torch.config import DetectorConfig
    from modular_slam_tpu_torch.ops.pyramid import build_pyramid

    levels = build_pyramid(torch.from_numpy(_img(hw, 4)), DetectorConfig())
    got = tfast.fast_score_levels(levels)
    assert len(got) == len(levels) == 8
    for lvl, (img, score) in enumerate(zip(levels, got)):
        ref = np.asarray(jfast.fast_score(jnp.asarray(img.numpy())))
        np.testing.assert_array_equal(score.numpy(), ref, err_msg=str(lvl))


def _pyramid_shapes(h, w):
    from modular_slam_tpu_torch.config import DetectorConfig
    from modular_slam_tpu_torch.ops.pyramid import pyramid_shapes

    return pyramid_shapes(h, w, DetectorConfig())


def _block_origin(first, shapes, block):
    """(level, y0, x0) of a block as csrc/fast_score.cu finds them: scan
    the tile prefix for the level, then split the tile index row-major."""
    lvl = 0
    while lvl + 1 < len(shapes) and block >= first[lvl + 1]:
        lvl += 1
    tile = tfast.FAST_TILE
    tiles_x = -(-shapes[lvl][1] // tile)
    t = block - first[lvl]
    return lvl, (t // tiles_x) * tile, (t % tiles_x) * tile


@pytest.mark.parametrize("shapes", [
    _pyramid_shapes(480, 640),
    _pyramid_shapes(97, 131),
    [(1, 1), (3, 5), (33, 31), (64, 64), (65, 97), (2, 200), (200, 2)],
], ids=["default-8-levels", "odd-pyramid", "odd-shapes"])
def test_fast_tile_table_covers_every_pixel_once(shapes):
    """Kernel K1's launch geometry: blocks found by scanning the tile
    prefix, each thread on rows ty + 8j of a 32x32 tile, cover every
    output pixel of every level exactly once."""
    first = tfast.fast_tile_table(shapes)
    assert len(first) == len(shapes) + 1 and first[0] == 0
    tile = tfast.FAST_TILE
    rows = sorted(ty + 8 * j for ty in range(8) for j in range(tile // 8))
    assert rows == list(range(tile))     # 32x8 threads, 4 rows each
    hits = [np.zeros(s, np.int32) for s in shapes]
    for block in range(first[-1]):
        lvl, y0, x0 = _block_origin(first, shapes, block)
        h, w = shapes[lvl]
        assert 0 <= y0 < h and 0 <= x0 < w
        hits[lvl][y0:y0 + tile, x0:x0 + tile] += 1
    for lvl, h in enumerate(hits):
        assert (h == 1).all(), lvl


def _ladder_16x9(d, reduce_min):
    """The JAX fast_score ladder on [N, 16]: per start k the window
    d[k .. k+8] (circular), then the other reduction over the starts."""
    lo, hi = (torch.minimum, torch.maximum) if reduce_min else \
        (torch.maximum, torch.minimum)
    acc = None
    for k in range(16):
        m = d[:, k]
        for j in range(1, 9):
            m = lo(m, d[:, (k + j) % 16])
        acc = m if acc is None else hi(acc, m)
    return acc


def _ladder_pair_quad(d, reduce_min):
    """csrc/fast_score.cu `ladder`: pair minima p_i = d[2i+1] ^ d[2i+2],
    q_i = p_i ^ p_{i+1}, m_i = q_i ^ q_{i+2} = d[2i+1 .. 2i+8]; the windows
    d[2i] ^ m_i and m_i ^ d[2i+9] taken together as m_i ^ (d[2i] v
    d[2i+9]) (^ the window reduction, v the other one)."""
    lo, hi = (torch.minimum, torch.maximum) if reduce_min else \
        (torch.maximum, torch.minimum)
    p = [lo(d[:, 2 * i + 1], d[:, (2 * i + 2) % 16]) for i in range(8)]
    q = [lo(p[i], p[(i + 1) % 8]) for i in range(8)]
    acc = None
    for i in range(8):
        m = lo(q[i], q[(i + 2) % 8])
        win = lo(m, hi(d[:, 2 * i], d[:, (2 * i + 9) % 16]))
        acc = win if acc is None else hi(acc, win)
    return acc


@pytest.mark.parametrize("kind", ["uniform", "integers"])
def test_pair_quad_ladder_equals_16x9_ladder(kind):
    """K1's shorter ladder gives the same bright and dark scores bit for
    bit on 10^4 random 16-vectors, and on integer-valued ones with many
    ties."""
    rng = np.random.default_rng(9)
    if kind == "uniform":
        d = rng.uniform(-255, 255, (10_000, 16))
    else:
        d = rng.integers(-3, 4, (10_000, 16))
    d = torch.from_numpy(d.astype(np.float32))
    for reduce_min in (True, False):
        assert torch.equal(_ladder_pair_quad(d, reduce_min),
                           _ladder_16x9(d, reduce_min))


@pytest.mark.parametrize("kind", ["uniform", "integers"])
def test_compass_pair_skip_keeps_every_score(kind):
    """K1 runs a ladder only where two compass pixels 4 apart (0, 4, 8,
    12) lie on its side of the centre; the score max(bright, dark, 0) is
    the same as with both ladders everywhere."""
    rng = np.random.default_rng(10)
    if kind == "uniform":
        d = rng.uniform(-255, 255, (10_000, 16))
    else:
        d = rng.integers(-2, 3, (10_000, 16))
    d = torch.from_numpy(d.astype(np.float32))
    bright = _ladder_16x9(d, True)
    dark = -_ladder_16x9(d, False)
    full = torch.clamp(torch.maximum(bright, dark), min=0.0)

    def pair(sign):
        c = [(sign * d[:, k]) > 0 for k in (0, 4, 8, 12)]
        return (c[0] & c[1]) | (c[1] & c[2]) | (c[2] & c[3]) | (c[3] & c[0])

    zero = torch.zeros_like(full)
    skipped = torch.maximum(torch.maximum(
        torch.where(pair(1), bright, zero), torch.where(pair(-1), dark, zero)),
        zero)
    assert torch.equal(skipped, full)
    assert 0 < int(pair(1).sum()) < d.shape[0]
