"""The port runs with jax blocked: in a subprocess where importing jax
fails, import modular_slam_tpu_torch and run three frames each of the
odometry preset (frame by frame and through the chunked path), the slam
preset (local BA) and the full preset (loop closure, relocalization, and
map compaction in a 2-keyframe pool) on the CPU; run the command-line
runner on data/sample, saving a checkpoint and resuming from it, and
write a dataset; track two sequences batched and evaluate data/sample;
run the viewer, its overlay and server, and the three sharded bundle
adjustments in a one-rank gloo world; call the reference ORB functions,
`detect_until` at each cut, `covis_counts`, `apply_backend_update` and a
one-candidate `geometric_verify`; run the port's benchmark's tracking
function at tiny size, which without a device named raises on a machine
with no card, and import the four `tools/torch_*.py` tools, running the
scan tool's matcher probes; `chip_smoke.py` imports too, and without a
card exits non-zero.  A bare `import modular_slam_tpu_torch`
gives the configs and imports no op."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    import modular_slam_tpu_torch as port
    assert port.SlamConfig().detector == port.DetectorConfig()
    assert port.tum_camera_config().width == 640
    assert not [m for m in sys.modules if m.startswith(
        "modular_slam_tpu_torch.ops")]
    from modular_slam_tpu_torch.config import MapConfig, tiny_test_config
    from modular_slam_tpu_torch.engine import SlamResult, SlamSystem
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.models import make_pipeline

    cfg = tiny_test_config()
    gen = PlaneSceneGenerator(cfg.camera, seed=2, texture_ppm=100.0)
    poses = gen.trajectory(3, step_t=(0.005, 0.002, 0.0))
    system = SlamSystem(cfg, device="cpu", seed=0, enable_backend=False)
    codes = [system.process(*f) for f in gen.sequence(poses)]
    assert codes == [SlamResult.SUCCESS] * 3, codes
    chunked = SlamSystem(cfg, device="cpu", seed=0, enable_backend=False)
    chunked.run(gen.sequence(poses), chunk=2)
    assert [bool(r.tracking_ok) for r in chunked.results] == [True] * 3
    slam = make_pipeline("slam", cfg, device="cpu", seed=0)
    codes = [slam.process(*f) for f in gen.sequence(poses)]
    assert codes == [SlamResult.SUCCESS] * 3, codes
    assert slam._backend.n_submitted >= 1
    full = make_pipeline("full", cfg.replace(map=MapConfig(
        max_keyframes=2, max_landmarks=512, max_observations=2048)),
        device="cpu", seed=0)
    codes = [full.process(*f) for f in gen.sequence(poses)]
    assert codes == [SlamResult.SUCCESS] * 3, codes
    assert full.n_compactions >= 1 and full._loop.db.valid.any()
    for m in ("backend.ba", "loop.pipeline", "backend.posegraph",
              "map.lifecycle"):
        assert "modular_slam_tpu_torch." + m in sys.modules, m
    import contextlib, io, json, os, tempfile
    from modular_slam_tpu_torch import run
    from modular_slam_tpu_torch.eval.make_dataset import write_dataset
    tmp = tempfile.mkdtemp()
    ck = os.path.join(tmp, "ck.npz")
    reports = io.StringIO()
    with contextlib.redirect_stdout(reports):
        assert run.main(["--dataset", "data/sample", "--cpu", "--out",
                         os.path.join(tmp, "traj.txt"), "--save-checkpoint",
                         ck]) == 0
        assert run.main(["--dataset", "data/sample", "--cpu", "--chunk",
                         "1", "--load-checkpoint", ck, "--max-frames",
                         "2"]) == 0
    first, resumed = map(json.loads, reports.getvalue().splitlines())
    assert first["tracked_ok"] == 16 and resumed["frames"] == 18
    assert write_dataset(os.path.join(tmp, "ds"), frames=2, laps=1,
                         width=32, height=24)["frames"] == 2
    for m in ("run", "utils.checkpoint", "io.native", "viz.png"):
        assert "modular_slam_tpu_torch." + m in sys.modules, m
    from modular_slam_tpu_torch.eval import evaluate
    from modular_slam_tpu_torch.parallel.multiseq import MultiSequenceRunner
    runner = MultiSequenceRunner(cfg, batch=2, chunk=2, device="cpu")
    runner.run([list(gen.sequence(poses))] * 2)
    assert runner.tracking_ok == [[True] * 3] * 2, runner.tracking_ok
    with contextlib.redirect_stdout(io.StringIO()):
        assert evaluate.main(["--datasets", "data/sample", "--out",
                              os.path.join(tmp, "eval"), "--pipeline",
                              "odometry", "--max-frames", "2",
                              "--cpu"]) == 0
    for m in ("eval.evaluate", "eval.report", "parallel.mesh",
              "parallel.dp", "parallel.multiseq"):
        assert "modular_slam_tpu_torch." + m in sys.modules, m
    from modular_slam_tpu_torch import viewer
    from modular_slam_tpu_torch.viz import make_overlay_fn
    from modular_slam_tpu_torch.viz.server import ViewerServer
    with contextlib.redirect_stderr(io.StringIO()):
        assert viewer.main(["--dataset", "data/sample", "--cpu",
                            "--max-frames", "2", "--out",
                            os.path.join(tmp, "viewer.txt")]) == 0
    od = make_overlay_fn(cfg, device="cpu")(slam.arena, slam.state,
                                            slam.last_features)
    assert int(od.valid.sum()) > 0
    ViewerServer(port=0).start().stop()
    import socket
    from modular_slam_tpu_torch.parallel import (
        make_halo_sharded_global_ba, make_kf_mesh, make_kf_sharded_global_ba,
        make_sharded_global_ba)
    from modular_slam_tpu_torch.parallel.bootstrap import (
        initialize_distributed, process_info)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0, cpu_gloo=True)
    assert process_info()["num_processes"] == 1
    mesh = make_kf_mesh(kf=1, obs=1)
    for make in (make_sharded_global_ba, make_kf_sharded_global_ba,
                 make_halo_sharded_global_ba):
        stats = make(cfg, mesh)(slam.arena)[1]
        assert float(stats.final_cost) <= float(stats.initial_cost)
    for m in ("viewer", "viz.overlay", "viz.scene", "viz.server",
              "parallel.bootstrap", "parallel.sharded_ba",
              "parallel.kf_sharded_ba", "parallel.halo_ba"):
        assert "modular_slam_tpu_torch." + m in sys.modules, m
    import torch
    from modular_slam_tpu_torch.geometry import camera_from_config, so3_exp
    from modular_slam_tpu_torch.io.tum import rgb_to_luma
    from modular_slam_tpu_torch.loop.detector import (LoopVerification,
                                                      geometric_verify)
    from modular_slam_tpu_torch.map import (apply_backend_update,
                                            covis_counts)
    from modular_slam_tpu_torch.ops import detect, gaussian_blur
    from modular_slam_tpu_torch.ops.brief import (brief_descriptors,
                                                  brief_from_atlas,
                                                  brief_matmul)
    from modular_slam_tpu_torch.ops.detector import CUTS, detect_until
    from modular_slam_tpu_torch.ops.orient import ic_angle, moment_maps
    from modular_slam_tpu_torch.ops.pnp import MultinomialSampler
    rgb, depth, _ = next(iter(gen.sequence(poses)))
    gray, depth = rgb_to_luma(torch.from_numpy(rgb)), torch.from_numpy(depth)
    outs = {cut: detect_until(gray, depth, cfg.detector, cut) for cut in CUTS}
    yx, lvl, _, atlas = outs["atlas"]
    ang = outs["orient"][3]
    assert torch.equal(outs["full"][1], detect(gray, depth,
                                               cfg.detector).keypoints.angle)
    blurred = gaussian_blur(gray)
    assert moment_maps(gray).shape == (2, *gray.shape)
    assert ic_angle(gray, yx).shape == ang.shape
    for bits in (brief_descriptors(blurred, yx, ang),
                 brief_from_atlas(atlas, lvl, yx + 3, ang),
                 brief_matmul(atlas, lvl, yx + 3, ang)):
        assert bits.shape == (cfg.detector.max_keypoints, 256)
    counts = covis_counts(slam.arena)
    assert int(counts[0, 0]) == int(slam.arena.inc[0].sum())
    kf = torch.ones(cfg.map.max_keyframes, dtype=torch.bool)
    moved = apply_backend_update(slam.arena, slam.arena.kf_q,
                                 slam.arena.kf_t + 1.0, slam.arena.lm_pos,
                                 kf, ~slam.arena.lm_valid)
    assert torch.equal(moved.kf_t, slam.arena.kf_t + 1.0)
    assert torch.equal(so3_exp(torch.zeros(3)), torch.tensor([1.0, 0, 0, 0]))
    ver = geometric_verify(slam.arena, torch.tensor(0), slam.last_features,
                           camera_from_config(cfg.camera), cfg,
                           MultinomialSampler(0))
    assert isinstance(ver, LoopVerification) and ver.ok.dim() == 0
    from modular_slam_tpu_torch import bench as port_bench
    big = cfg.replace(map=MapConfig(max_keyframes=64, max_landmarks=4096,
                                    max_observations=16384))
    bgen = PlaneSceneGenerator(cfg.camera, seed=42, texture_ppm=100.0)
    bframes = list(bgen.sequence(bgen.trajectory(
        35, step_t=(0.005, 0.002, 0.0), step_rot=(0.001, 0.002, 0.0))))
    detail = {}
    with contextlib.redirect_stderr(io.StringIO()):
        assert port_bench.bench_ours_tracking(big, bframes, device="cpu",
                                              detail=detail) > 0
    assert detail["tracked_ok"] == 16, detail
    if not torch.cuda.is_available():
        try:
            port_bench.bench_ours_tracking(big, bframes)
            raise AssertionError("bench ran without a card")
        except RuntimeError as e:
            assert "no CUDA device" in str(e)
    import importlib.util
    tools = {}
    for name in ("train_vocab", "detect_bench", "scan_bench", "ba_bench"):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join("tools", f"torch_{name}.py"))
        tools[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tools[name])
    with contextlib.redirect_stdout(io.StringIO()) as scan_out:
        assert tools["scan_bench"].main(["--device", "cpu", "--tiny",
                                         "--probe", "match", "--n", "2"]) == 0
    assert "match plain + dedupe" in scan_out.getvalue()
    import chip_smoke
    if not torch.cuda.is_available():
        assert chip_smoke.main() == 2      # no card: no result, non-zero
    leaked = sorted(m for m in sys.modules
                    if m == "modular_slam_tpu"
                    or m.startswith("modular_slam_tpu."))
    assert not leaked, leaked
    print("OK", system.n_keyframes, system.n_landmarks)
""")


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK"), out.stdout
