"""The port runs with jax blocked: in a subprocess where importing jax
fails, import modular_slam_tpu_torch and run three frames of the odometry
preset and three of the slam preset (local BA) on the CPU."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    from modular_slam_tpu_torch.config import tiny_test_config
    from modular_slam_tpu_torch.engine import SlamResult, SlamSystem
    from modular_slam_tpu_torch.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu_torch.models import make_pipeline

    cfg = tiny_test_config()
    gen = PlaneSceneGenerator(cfg.camera, seed=2, texture_ppm=100.0)
    poses = gen.trajectory(3, step_t=(0.005, 0.002, 0.0))
    system = SlamSystem(cfg, device="cpu", seed=0, enable_backend=False)
    codes = [system.process(*f) for f in gen.sequence(poses)]
    assert codes == [SlamResult.SUCCESS] * 3, codes
    slam = make_pipeline("slam", cfg, device="cpu", seed=0)
    codes = [slam.process(*f) for f in gen.sequence(poses)]
    assert codes == [SlamResult.SUCCESS] * 3, codes
    assert slam._backend.n_submitted >= 1
    assert "modular_slam_tpu_torch.backend.ba" in sys.modules
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
