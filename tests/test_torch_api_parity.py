"""The port's public surface against the JAX package's, module by module.

For every module of `modular_slam_tpu/`, each public name (a top-level
`def` or `class`, an upper-case constant, an alias such as
`so3_exp = quat_from_axis_angle`, and in an `__init__.py` each
re-export) must exist in the port's module at the same path, under the
mapped name below, or be on the exclusion list below, each with its
reason.  The JAX side is read with `ast` (nothing of it is imported); the
port's modules are imported, so a re-export that fails to import fails
here too.  Names with a leading underscore are out of scope.
"""

import ast
import importlib
import os

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_PKG = os.path.join(ROOT, "modular_slam_tpu")

# JAX module -> {public name: why the port has no counterpart}
EXCLUDED = {
    "prewarm": {
        "main": "fills XLA's persistent compile cache; the port compiles "
                "no XLA programs (ROADMAP §1 item 7)",
    },
    "utils.jaxtools": {
        "force_cpu": "selects JAX's platform; the port's entry points "
                     "take a device argument instead",
        "machine_fingerprint": "scopes XLA's compile cache by machine",
        "setup_compile_cache": "configures XLA's compile cache",
    },
    "utils": {
        "force_cpu": "re-export of utils.jaxtools.force_cpu",
        "setup_compile_cache": "re-export of utils.jaxtools."
                               "setup_compile_cache",
    },
    "ops.match_pallas": {
        "pallas_match_supported": "the CUDA kernel takes every shape that "
                                  "ops/match.py's `_check_splits` admits",
    },
}

# (JAX module, name) -> (port module, name): the Pallas modules' entry
# points are the CUDA kernels' wrappers
MAPPED = {
    ("ops.fast_pallas", "fast_score_pallas"): ("ops.fast", "fast_score_cuda"),
    ("ops.fast_pallas", "fast_score_fastest"): ("ops.fast", "fast_score"),
    ("ops.match_pallas", "match_descriptors_pallas"):
        ("ops.match", "match_descriptors_cuda"),
    ("ops.match_pallas", "match_descriptors_fastest"):
        ("ops.match", "match_descriptors"),
}


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                out.append(rel)
    return sorted(out)


def _dotted(rel: str) -> str:
    """"ops/brief.py" -> "ops.brief"; "ops/__init__.py" -> "ops"; the
    package's own __init__ -> ""."""
    parts = rel[:-3].split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def public_names(path: str):
    """{name: kind} of a module's public names, kind one of "def",
    "class", "constant", "alias", "reexport"."""
    with open(path) as f:
        tree = ast.parse(f.read())
    is_init = os.path.basename(path) == "__init__.py"
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = "def"
        elif isinstance(node, ast.ClassDef):
            out[node.name] = "class"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if isinstance(node.value, ast.Name):
                    out[t.id] = "alias"
                elif t.id.isupper():
                    out[t.id] = "constant"
        elif is_init and isinstance(node, ast.ImportFrom):
            for a in node.names:
                out[a.asname or a.name] = "reexport"
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _port(dotted: str):
    name = "modular_slam_tpu_torch" + ("." + dotted if dotted else "")
    return importlib.import_module(name)


@pytest.mark.parametrize("rel", _jax_modules())
def test_public_names_have_port_counterparts(rel):
    mod = _dotted(rel)
    names = public_names(os.path.join(JAX_PKG, rel))
    excluded = EXCLUDED.get(mod, {})
    stale = sorted(set(excluded) - set(names)) + sorted(
        n for (m, n) in MAPPED if m == mod and n not in names)
    assert not stale, f"{mod}: listed names that it no longer has: {stale}"
    missing = []
    for name, kind in sorted(names.items()):
        if name in excluded:
            continue
        port_mod, port_name = MAPPED.get((mod, name), (mod, name))
        obj = getattr(_port(port_mod), port_name, None)
        if obj is None or (kind in ("def", "class") and not callable(obj)):
            missing.append(f"{name} ({kind}) -> "
                           f"modular_slam_tpu_torch.{port_mod}:{port_name}")
    assert not missing, f"modular_slam_tpu.{mod}: no counterpart for " \
                        f"{missing}"


def test_walk_sees_every_kind():
    """The reader finds each kind of public name it is meant to find."""
    geo = public_names(os.path.join(JAX_PKG, "geometry", "se3.py"))
    assert geo["so3_exp"] == "alias" and geo["Pose"] == "class"
    assert geo["pose_compose"] == "def"
    assert public_names(os.path.join(JAX_PKG, "ops", "orient.py"))[
        "IC_RADIUS"] == "constant"
    top = public_names(os.path.join(JAX_PKG, "__init__.py"))
    assert top["SlamConfig"] == "reexport" and "__version__" not in top
