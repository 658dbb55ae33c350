"""The port's measuring and vocabulary tools (`tools/torch_*.py`) against
the JAX tools they port, on the CPU.

- `tools/torch_train_vocab.py`: `sweep` equals `tools/train_vocab.py`'s
  on the same score arrays; `harvest_descriptors` at tiny size (2 rendered
  scenes x 3 frames, no files read) gives JAX's rows, all but at most 1 %
  of them bit for bit (the IC angle moves a BRIEF bin in about 1 of 606
  keypoints, ROADMAP "Differences held"); `train_vocab` on one descriptor
  array with one seed gives JAX's codebook; its `main` writes a codebook
  that `load_trained_vocab` reads;
- the three timing tools run with `--device cpu --tiny` and print the JAX
  tools' keys: `tools/detect_bench.py`'s `substage_ms` and
  `bytes_lower_bound` keys (read from its source with `ast`), the labels
  `tools/scan_bench.py` prints (its "XLA" matcher is the port's "plain";
  its "Pallas" lines, like the port's kernel lines, need the device), and
  `tools/ba_bench.py`'s.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from modular_slam_tpu.config import tiny_test_config as jax_tiny_config
from modular_slam_tpu_torch.config import tiny_test_config

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TOOLS = os.path.join(ROOT, "tools")
ROW_MISMATCH_MAX = 0.01


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vocab_tools():
    return _tool("train_vocab"), _tool("torch_train_vocab")


def test_sweep_equals_jax(vocab_tools):
    jax_tool, port_tool = vocab_tools
    rng = np.random.default_rng(1)
    same, diff = rng.uniform(0.2, 0.9, 24), rng.uniform(0.0, 0.5, 90)
    assert port_tool.sweep(same, diff) == jax_tool.sweep(same, diff)


def test_harvest_matches_jax(vocab_tools, monkeypatch, tmp_path):
    jax_tool, port_tool = vocab_tools
    # the JAX tool reads TUM frames from directories relative to the
    # working directory: an empty one leaves it the rendered scenes only
    monkeypatch.chdir(tmp_path)
    ref = jax_tool.harvest_descriptors(jax_tiny_config(), 2, 3)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = port_tool.harvest_descriptors(tiny_test_config(), 2, 3,
                                            device="cpu", roots=())
    finally:
        torch.set_num_threads(n)
    assert out.dtype == np.int8 and out.shape == ref.shape
    differ = np.any(out != ref, axis=1).mean()
    assert differ <= ROW_MISMATCH_MAX, differ


def test_train_vocab_gives_jax_codebook():
    from modular_slam_tpu.loop.vocab import train_vocab as jax_train
    from modular_slam_tpu_torch.loop.vocab import train_vocab

    rng = np.random.default_rng(5)
    desc = (rng.integers(0, 2, (1500, 256)) * 2 - 1).astype(np.int8)
    np.testing.assert_array_equal(train_vocab(desc, 64, iters=4, seed=9),
                                  jax_train(desc, 64, iters=4, seed=9))


def _run(*args, timeout=300):
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_vocab_main_writes_a_loadable_codebook(tmp_path,
                                                     monkeypatch):
    out = tmp_path / "vocab_64_256.npz"
    last = json.loads(_run(
        os.path.join(TOOLS, "torch_train_vocab.py"), "--device", "cpu",
        "--tiny", "--scenes", "2", "--frames-per-scene", "2",
        "--revisit-scenes", "1", "--vocab-size", "64", "--iters", "2",
        "--out", str(out)).splitlines()[-1])
    assert last["out"] == str(out) and last["vocab_shape"] == [64, 256]
    from modular_slam_tpu_torch.loop import vocab

    # where load_trained_vocab looks for the packaged codebooks
    monkeypatch.setattr(vocab, "_VOCAB_DIR", str(tmp_path))
    codebook = vocab.load_trained_vocab(64)
    with np.load(out) as f:
        np.testing.assert_array_equal(codebook, f["vocab"])
    assert codebook.dtype == np.int8 and set(np.unique(codebook)) <= {-1, 1}
    assert not np.array_equal(codebook, vocab.make_vocab(64))


def _detect_bench_keys():
    """`substage_ms` and `bytes_lower_bound` keys of tools/detect_bench.py:
    its `res["..."]` stores, the cut loop's `f"cut_{cut}_ms"` and the
    `lb` dict literal."""
    with open(os.path.join(TOOLS, "detect_bench.py")) as f:
        tree = ast.parse(f.read())
    res, lb = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.value,
                                                           ast.Name)
                and node.value.id == "res"
                and isinstance(node.slice, ast.Constant)):
            res.add(node.slice.value)
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == "cut":
            res.update(f"cut_{c.value}_ms" for c in node.iter.elts)
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "lb"
                        for t in node.targets)):
            lb.update(k.value for k in node.value.keys)
    return res, lb


def _scan_bench_labels():
    """The labels tools/scan_bench.py passes to `scan_probe`, its matcher
    named as the port names it: XLA -> plain, Pallas -> kernel."""
    with open(os.path.join(TOOLS, "scan_bench.py")) as f:
        tree = ast.parse(f.read())
    labels = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "scan_probe"):
            label = node.args[-1]
            if isinstance(label, ast.JoinedStr):
                label = "".join(
                    v.value if isinstance(v, ast.Constant) else "{}"
                    for v in label.values)
            else:
                label = label.value
            labels.add(label.replace("XLA", "plain")
                       .replace("Pallas", "kernel"))
    return labels


@pytest.mark.parametrize("tool", ["detect", "scan", "ba"])
def test_timing_tool_prints_jax_keys(tool):
    stdout = _run(os.path.join(TOOLS, f"torch_{tool}_bench.py"), "--device",
                  "cpu", "--tiny")
    if tool == "detect":
        out = json.loads(stdout)
        res, lb = _detect_bench_keys()
        assert set(out["substage_ms"]) == res and len(res) == 17
        assert lb <= set(out["bytes_lower_bound"]) and len(lb) == 7
        assert out["bytes_lower_bound"]["bound_ms_at_3.35TBps"] > 0
        assert set(out["device_busy_ms_per_frame"]) and out["gpu"] is None
        return
    out = json.loads(stdout.splitlines()[-1])
    if tool == "scan":
        cfg = tiny_test_config()
        shape = f"{cfg.detector.max_keypoints}x{cfg.map.max_landmarks}"
        want = {lab.replace("{}x{}", shape) for lab in _scan_bench_labels()
                if "kernel" not in lab}
        assert len(want) == 7 and set(out["ms_per_frame"]) == want
    else:
        want = {"local_ba total", "compact only"} | {
            f"dense core {i:2d} iters" for i in (1, 2, 5, 10)}
        assert set(out["ms"]) == want
        for label in want:
            assert f"{label}: " in stdout
    assert all(v > 0 for v in (out.get("ms_per_frame") or out["ms"])
               .values())
