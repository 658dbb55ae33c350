"""Fixtures of the benchmark's CPU tests: the cells of BENCHMARK.json cut
to a size the CPU runs in seconds (the same code paths, fewer pixels,
sequences and map rows), and the `card` marker for tests that need the
H100.  Whether a card is there is decided inside the `card` fixture,
never at import time."""

from __future__ import annotations

import copy

import pytest
import torch

from port_bench import run as R
from port_bench import scene


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (the H100); "
                            "skipped where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    return torch.device("cuda")


class Args:
    def __init__(self, seed, seconds, trace=0):
        self.seed, self.seconds, self.trace = seed, seconds, trace


def tiny_fleet(name="fr1_desk.fleet"):
    cell = copy.deepcopy(R.load_cell(name))
    cell["config"]["sensor"].update(width=320, height=240, fx=262.5, fy=262.5,
                                    cx=159.5, cy=119.5)
    cell["config"]["slam"].update(n_levels=4, max_keypoints=256, max_keyframes=64,
                                  max_landmarks=8192, max_observations=32768)
    # a keyframe at least every 8 frames, so that the 16 frames of the
    # check chunks hold one in every sequence
    cell["config"]["slam"]["tracker"]["max_kf_interval"] = 8
    cell["traffic"].update(batch=2, chunk=4, bank_frames=16, warmup_chunks=1,
                           trace_chunks=1, keypoint_sequences=2,
                           check_chunks=4, check_sequences=2)
    return cell


def tiny_gba():
    cell = copy.deepcopy(R.load_cell("fr1_room.gba"))
    cell["config"]["slam"].update(max_keyframes=128, max_landmarks=2048,
                                  max_observations=16384)
    cell["config"]["map"].update(keyframes=120, landmarks=1500, observations=9000)
    cell["traffic"].update(tier=[128, 2048, 16384], trace_calls=1)
    return cell


@pytest.fixture
def cpu_run(monkeypatch):
    """run(cell, seed, seconds) on the CPU: the harness with its look for
    a card skipped and the card's memory counters stubbed."""
    monkeypatch.setattr(scene, "TEXTURE_SIZE", 4096)
    for f in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, f, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)

    def go(cell, seed=2 ** 31 + 17, seconds=1.5):
        return R.run(Args(seed, seconds), cell, device_check=False, device="cpu")
    return go
