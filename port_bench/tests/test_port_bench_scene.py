"""The device renderer against the frozen copy of the box scene's ray
cast, and the texture against a plain painting loop."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import scene


def test_texture_paints_later_squares_over_earlier_ones():
    size = 64
    gen = torch.Generator().manual_seed(3)
    tex = scene.make_texture(gen, size, "cpu")
    gen = torch.Generator().manual_seed(3)
    n = (size // 8) ** 2
    ys = torch.randint(0, size - 12, (n,), generator=gen).numpy()
    xs = torch.randint(0, size - 12, (n,), generator=gen).numpy()
    side = torch.randint(3, 10, (n,), generator=gen).numpy()
    val = (torch.rand(n, generator=gen) * 255.0).numpy()
    ref = np.full((size, size), 128.0, np.float32)
    for y, x, s, v in zip(ys, xs, side, val):
        ref[y:y + s, x:x + s] = v
    k = np.exp(-0.5 * (np.arange(-1, 2) / 0.8) ** 2)
    k /= k.sum()
    pad = np.pad(ref, 1, mode="reflect")
    rows = sum(k[i] * pad[:, i:i + size] for i in range(3))
    ref = sum(k[i] * rows[i:i + size, :] for i in range(3))
    np.testing.assert_allclose(tex.numpy(), ref, atol=1e-3)


def test_render_equals_the_frozen_ray_cast():
    cam = scene.Camera(100.0, 100.0, 79.5, 59.5, 160, 120)
    gen = torch.Generator().manual_seed(1)
    tex = scene.make_texture(gen, 1024, "cpu")
    rng = np.random.default_rng(9)
    rects = scene.room_rects(rng, 6, 1024)
    R, t = scene.sweep_path(rng, 3, 0.413, 23.3, 30.0)
    g, d = scene.render(cam, rects, tex, torch.as_tensor(R), torch.as_tensor(t))
    for f in range(3):
        g_ref, d_ref = scene.render_numpy(cam, rects, tex.numpy(), R[f], t[f])
        np.testing.assert_allclose(d[f].numpy(), d_ref, rtol=1e-6)
        # the uint8 cast can round a grey a hair below an integer down
        assert np.mean(g[f].numpy() != g_ref) < 1e-3
        assert np.abs(g[f].numpy() - g_ref).max() <= 1.0


def test_sweep_path_moves_at_the_configured_rate():
    rng = np.random.default_rng(2)
    R, t = scene.sweep_path(rng, 32, 0.413, 23.3, 30.0)
    # a closed sweep: the last frame leads into the first like any other
    R = np.concatenate([R, R[:1]])
    t = np.concatenate([t, t[:1]])
    step = np.linalg.norm(np.diff(t, axis=0), axis=1)
    np.testing.assert_allclose(step, 0.413 / 30.0)
    ang = [np.degrees(np.arccos(np.clip((np.trace(R[i].T @ R[i + 1]) - 1) / 2,
                                        -1, 1))) for i in range(32)]
    assert abs(np.mean(ang) - 23.3 / 30.0) < 0.1 * 23.3 / 30.0
    assert max(ang) < 2.0 * 23.3 / 30.0


def test_kinect_depth_noise_and_quantisation():
    gen = torch.Generator().manual_seed(0)
    d = torch.full((200, 200), 3.0)
    d[0, 0] = 0.0
    z = scene.kinect_depth(d, gen)
    assert z[0, 0] == 0.0
    np.testing.assert_allclose((z[1:] * 5000).numpy(),
                               np.round((z[1:] * 5000).numpy()), atol=1e-3)
    sigma = 0.0012 + 0.0019 * (3.0 - 0.4) ** 2
    assert abs(float(z[1:].std()) - sigma) < 0.1 * sigma
