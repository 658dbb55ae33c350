"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault the cell can have (a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced, the matcher's answers among them; the
cells run on one chip, so no exchange between chips can be left out).  The control, the plain pipeline in
bfloat16 in the port's place, must come out not correct too."""

from __future__ import annotations

import pytest
import torch

from port_bench import run as R
from port_bench.tests.conftest import tiny_fleet, tiny_gba


def _broken_scan(monkeypatch, wrap):
    import modular_slam_tpu_torch.parallel.multiseq as ms

    real = ms.make_batch_slam_scan
    monkeypatch.setattr(ms, "make_batch_slam_scan",
                        lambda cfg, mesh, axis="seq": wrap(real(cfg, mesh, axis)))


def _clone(tree):
    from modular_slam_tpu_torch.parallel.dp import tree_map

    return tree_map(lambda x: x.clone(), tree)


def test_fleet_state_left_unchanged(cpu_run, monkeypatch):
    def wrap(scan):
        def broken(arenas, states, *rest):
            _, _, results = scan([_clone(a) for a in arenas],
                                 [_clone(s) for s in states], *rest)
            return arenas, states, results
        return broken

    _broken_scan(monkeypatch, wrap)
    assert not cpu_run(tiny_fleet())["correct"]


def test_fleet_half_the_batch_left_out(cpu_run, monkeypatch):
    from modular_slam_tpu_torch.parallel.dp import tree_map

    def wrap(scan):
        def broken(arenas, states, grays, depths, times, keys, bootstrap=False):
            h = times.shape[1] // 2
            half = lambda x: x[:h]  # noqa: E731
            a, s, r = scan([tree_map(half, arenas[0])], [tree_map(half, states[0])],
                           grays[:, :h], depths[:, :h], times[:, :h],
                           keys[:, :h], bootstrap)
            tree_map(lambda full, new: full[:h].copy_(new), arenas[0], a[0])
            tree_map(lambda full, new: full[:h].copy_(new), states[0], s[0])
            return arenas, states, tree_map(
                lambda x: torch.cat([x, x], dim=1), r)
        return broken

    _broken_scan(monkeypatch, wrap)
    assert not cpu_run(tiny_fleet())["correct"]


def test_fleet_pose_altered_where_produced(cpu_run, monkeypatch):
    import modular_slam_tpu_torch.frontend.tracker as tracker

    real = tracker.ransac_pnp

    def altered(*args, **kw):
        out = real(*args, **kw)
        return out._replace(pose=out.pose._replace(t=out.pose.t + 0.02))

    monkeypatch.setattr(tracker, "ransac_pnp", altered)
    assert not cpu_run(tiny_fleet())["correct"]


@pytest.mark.parametrize("fault", ["every_second_match_dropped",
                                   "matched_to_the_next_landmark"])
def test_fleet_matches_altered_where_produced(fault, cpu_run, monkeypatch):
    """K2 and its merge losing matches, or matching the wrong landmark,
    fail the comparison of the inserted observations itself."""
    import modular_slam_tpu_torch.frontend.tracker as tracker

    real = tracker.match_descriptors

    def altered(q, qv, t, tv, cfg):
        m = real(q, qv, t, tv, cfg)
        if fault == "every_second_match_dropped":
            keep = torch.arange(m.valid.shape[-1], device=m.valid.device) % 2 == 0
            return m._replace(valid=m.valid & keep)
        return m._replace(lm_slot=(m.lm_slot + 1) % t.shape[-2])

    monkeypatch.setattr(tracker, "match_descriptors", altered)
    cell = tiny_fleet()
    res = cpu_run(cell)
    assert not res["correct"]
    assert res["checks"]["match_gap_pct"]["value"] > cell["limits"]["match_gap_pct"]


def _broken_gba(monkeypatch, wrap):
    import modular_slam_tpu_torch.backend.ba as ba

    real = ba.make_global_ba_compact
    monkeypatch.setattr(ba, "make_global_ba_compact",
                        lambda *a, **k: wrap(real(*a, **k)))


def test_gba_state_left_unchanged(cpu_run, monkeypatch):
    def wrap(fn):
        def broken(arena):
            _, stats = fn(type(arena)(*[x.clone() for x in arena]))
            return arena, stats
        return broken

    _broken_gba(monkeypatch, wrap)
    assert not cpu_run(tiny_gba())["correct"]


def test_gba_half_the_rows_left_out(cpu_run, monkeypatch):
    def wrap(fn):
        def broken(arena):
            n = int(arena.n_obs)
            arena.obs_valid[n // 2:n] = False
            return fn(arena)
        return broken

    _broken_gba(monkeypatch, wrap)
    assert not cpu_run(tiny_gba())["correct"]


def test_gba_landmarks_altered_where_produced(cpu_run, monkeypatch):
    def wrap(fn):
        def broken(arena):
            arena, stats = fn(arena)
            arena.lm_pos.add_(0.05)
            return arena, stats
        return broken

    _broken_gba(monkeypatch, wrap)
    assert not cpu_run(tiny_gba())["correct"]


@pytest.mark.parametrize("make", [tiny_fleet, tiny_gba], ids=["fleet", "gba"])
def test_the_bfloat16_control_is_not_correct(make, cpu_run, monkeypatch):
    """The control at a tiny size; on the card it runs at the cell's size
    (`python3 port_bench/probe.py control ...`)."""
    cell = make()
    res = cpu_run(cell)
    assert res["correct"]
    drv = R.make_driver(cell, 2 ** 31 + 23, device="cpu")
    drv.setup()
    drv.window(1.0)
    drv.collect()
    ok, checks = R.judge(drv.numbers(dtype=torch.bfloat16), cell["limits"])
    assert not ok, checks
