"""The port's public surface against the JAX package's, module by module.

For every module of `modular_slam_tpu/`, each public name (a top-level
`def` or `class`, an upper-case constant, an alias such as
`so3_exp = quat_from_axis_angle`, and in an `__init__.py` each
re-export) must exist in the port's module at the same path, under the
mapped name below, or be on the exclusion list below, each with its
reason.  The JAX side is read with `ast` (nothing of it is imported); the
port's modules are imported, so a re-export that fails to import fails
here too.  Names with a leading underscore are out of scope.

Beyond the names, a call written for the JAX package must bind the same
way in the port:
- signatures: of every public def, every public class's `__init__` and
  `__call__` and every public method, JAX's positional parameters are a
  prefix of the port's, by name, JAX's
  keyword-only ones are keywords of the port's, the port's own are
  keyword-only or come last with a default, and defaults are equal
  (a non-literal JAX default is read in the port module's namespace);
- class members: every public method, property and class attribute of a
  public JAX class exists on the port's class;
- record fields: a JAX NamedTuple's or dataclass's fields are a prefix of
  the port's, with equal defaults, and the port's extra fields have
  defaults.
The port's side is read with `inspect` on the imported objects, so a
wrapper cannot hide what a caller meets; every listed exception gives its
reason, and one that names what JAX no longer has fails.
"""

import ast
import dataclasses
import importlib
import inspect
import os
import types

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


# --- signatures, class members and record fields ----------------------------

# (JAX module, qualified name, parameter) -> why the defaults differ
DEFAULT_DIFFERS = {
    ("ops.fast", "border_mask", "dtype"):
        "jnp.float32 is torch.float32 in the port",
    ("geometry.se3", "identity_pose", "dtype"):
        "jnp.float32 is torch.float32 in the port",
    ("backend.cg", "pcg", "dot"):
        "jnp.vdot is torch.dot in the port",
}

# (JAX module, class, member) -> why the port's class has no such member
MEMBER_EXCLUDED = {
    ("loop.pipeline", "LoopPipeline", "start_background_prewarm"):
        "compiles the global-BA tiers into XLA's compile cache in a "
        "background thread; the port compiles no XLA programs (ROADMAP §1 "
        "item 7)",
    ("loop.pipeline", "LoopPipeline", "prewarm_for_counts"):
        "compiles the global-BA tiers into XLA's compile cache; the port "
        "compiles no XLA programs (ROADMAP §1 item 7)",
}


def _is_record(node: ast.ClassDef) -> bool:
    """A NamedTuple or a dataclass: its fields are its constructor."""
    bases = [ast.unparse(b) for b in node.bases]
    decos = [ast.unparse(d) for d in node.decorator_list]
    return (any(b.split(".")[-1] == "NamedTuple" for b in bases)
            or any(d.split("(")[0].split(".")[-1] == "dataclass"
                   for d in decos))


def _arg_spec(fn: ast.FunctionDef):
    """(positional [(name, default node or None)], keyword-only [...],
    has *args, has **kwargs) of a `def`, as written."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    return ([(p.arg, d) for p, d in zip(pos, defaults)],
            [(p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)],
            a.vararg is not None, a.kwarg is not None)


def _decorators(fn) -> set:
    return {ast.unparse(d).split(".")[-1] for d in fn.decorator_list}


def class_api(path: str):
    """{class: {"record": bool, "fields": [(name, default node or None)],
    "methods": {name: FunctionDef}, "properties": set, "attributes": set}}
    of a module's public classes, members inherited from a base class of
    the same module included."""
    with open(path) as f:
        tree = ast.parse(f.read())
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def members(node: ast.ClassDef):
        out = {"record": _is_record(node), "fields": [], "methods": {},
               "properties": set(), "attributes": set()}
        for base in node.bases:          # in-module bases first
            if isinstance(base, ast.Name) and base.id in classes:
                inherited = members(classes[base.id])
                for k in ("methods", "properties", "attributes"):
                    out[k].update(inherited[k])
        for m in node.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if {"property", "setter", "cached_property"} & \
                        _decorators(m):
                    out["properties"].add(m.name)
                    out["methods"].pop(m.name, None)
                else:
                    out["methods"][m.name] = m
            elif (isinstance(m, ast.AnnAssign) and out["record"]
                  and isinstance(m.target, ast.Name)
                  and "ClassVar" not in ast.unparse(m.annotation)):
                out["fields"].append((m.target.id, m.value))
            elif isinstance(m, ast.Assign) or (
                    isinstance(m, ast.AnnAssign) and m.value is not None):
                targets = (m.targets if isinstance(m, ast.Assign)
                           else [m.target])
                out["attributes"].update(
                    t.id for t in targets if isinstance(t, ast.Name))
        return out

    return {name: members(node) for name, node in classes.items()
            if not name.startswith("_")}


def def_api(path: str):
    """{qualified name: FunctionDef} of a module's public functions and its
    public classes' `__init__`, `__call__` and public methods (properties
    are members, not signatures)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
           and not n.name.startswith("_")}
    for cls, api in class_api(path).items():
        for name, fn in api["methods"].items():
            if not name.startswith("_") or name in ("__init__", "__call__"):
                out[f"{cls}.{name}"] = fn
    return out


def _port_object(mod: str, qualname: str):
    """The port's object for a JAX module's qualified name (None if
    absent), through `MAPPED` for the Pallas entry points; a method is read
    off its class statically, so a staticmethod or classmethod is its
    function."""
    head, _, member = qualname.partition(".")
    port_mod, port_name = MAPPED.get((mod, head), (mod, head))
    obj = getattr(_port(port_mod), port_name, None)
    if obj is None or not member:
        return obj
    try:
        obj = inspect.getattr_static(obj, member)
    except AttributeError:
        return None
    return getattr(obj, "__func__", obj)


def _default_value(node, mod: str):
    """A JAX default's value, read in the port module's namespace where it
    is not a literal (a constant such as `IC_RADIUS` is then the port's)."""
    try:
        return ast.literal_eval(node)
    except ValueError:
        return eval(compile(ast.Expression(node), "<default>", "eval"),
                    vars(_port(mod)))


def _same(a, b) -> bool:
    """Equal defaults: equal values of one type (an int and a float of one
    value agree), or two lambdas of one body (`lambda x: x`)."""
    if isinstance(a, types.FunctionType) and isinstance(
            b, types.FunctionType):
        return (a.__code__.co_code == b.__code__.co_code
                and a.__code__.co_varnames == b.__code__.co_varnames)
    if {type(a), type(b)} == {int, float}:
        return a == b
    return type(a) is type(b) and bool(a == b)


def _default_problem(mod, where, jax_default, port_default):
    """None if a JAX default and the port's agree, else what differs."""
    if jax_default is None:
        return None
    if port_default is inspect.Parameter.empty:
        return f"{where}: JAX default {ast.unparse(jax_default)}, none " \
               f"in the port"
    try:
        value = _default_value(jax_default, mod)
    except Exception as e:
        return f"{where}: JAX default {ast.unparse(jax_default)} has no " \
               f"meaning in the port ({type(e).__name__}: {e})"
    if not _same(value, port_default):
        return f"{where}: JAX default {ast.unparse(jax_default)}, port " \
               f"default {port_default!r}"
    return None


def signature_problems(mod: str, qualname: str, fn: ast.FunctionDef,
                       port_obj) -> list:
    """What in the port's signature breaks a call written for JAX's."""
    jpos, jkw, jvar, jvarkw = _arg_spec(fn)
    params = list(inspect.signature(port_obj).parameters.values())
    P = inspect.Parameter
    ppos = [p for p in params
            if p.kind in (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)]
    by_name = {p.name: p for p in params}
    jnames = [n for n, _ in jpos]
    pnames = [p.name for p in ppos]
    out = []
    if pnames[:len(jnames)] != jnames:
        out.append(f"{qualname}: JAX's positional parameters {jnames} are "
                   f"not a prefix of the port's {pnames}")
    for name, _ in jkw:
        p = by_name.get(name)
        if p is None or p.kind == P.POSITIONAL_ONLY:
            out.append(f"{qualname}: JAX's keyword-only `{name}` is not a "
                       f"keyword of the port's")
    if jvar and not any(p.kind == P.VAR_POSITIONAL for p in params):
        out.append(f"{qualname}: JAX takes *args, the port does not")
    if jvarkw and not any(p.kind == P.VAR_KEYWORD for p in params):
        out.append(f"{qualname}: JAX takes **kwargs, the port does not")
    known = set(jnames) | {n for n, _ in jkw}
    for i, p in enumerate(params):
        if p.name in known or p.kind in (P.KEYWORD_ONLY, P.VAR_POSITIONAL,
                                         P.VAR_KEYWORD):
            continue
        if i < len(jnames) or p.default is P.empty:
            out.append(f"{qualname}: the port's `{p.name}`, which JAX lacks,"
                       f" is positional at {i} and not after JAX's "
                       f"parameters with a default")
    for name, default in jpos + jkw:
        p = by_name.get(name)
        if p is None or (mod, qualname, name) in DEFAULT_DIFFERS:
            continue
        problem = _default_problem(mod, f"{qualname}({name})", default,
                                   p.default)
        if problem:
            out.append(problem)
    return out


def _stale(listing, mod, present):
    return sorted(k[1:] for k in listing if k[0] == mod
                  and not present(*k[1:]))


@pytest.mark.parametrize("rel", _jax_modules())
def test_signatures_take_jax_calls(rel):
    """Every public def, method, `__init__` and `__call__` of the JAX
    module takes a call written for JAX the same way in the port: JAX's
    positional parameters in JAX's order first, its keyword-only ones by
    name, the port's own extras keyword-only (or last, with a default),
    and equal defaults."""
    mod = _dotted(rel)
    path = os.path.join(JAX_PKG, rel)
    defs = def_api(path)

    def has_param(qualname, param):
        if qualname not in defs:
            return False
        positional, keyword, _, _ = _arg_spec(defs[qualname])
        return param in [n for n, _ in positional + keyword]

    stale = _stale(DEFAULT_DIFFERS, mod, has_param)
    assert not stale, f"{mod}: DEFAULT_DIFFERS lists what JAX no longer " \
                      f"has: {stale}"
    excluded = EXCLUDED.get(mod, {})
    problems = []
    for qualname, fn in sorted(defs.items()):
        cls, _, member = qualname.rpartition(".")
        if (qualname.split(".")[0] in excluded
                or (mod, cls, member) in MEMBER_EXCLUDED):
            continue
        port_obj = _port_object(mod, qualname)
        if port_obj is None:
            problems.append(f"{qualname}: absent from the port")
            continue
        problems += signature_problems(mod, qualname, fn, port_obj)
    assert not problems, f"modular_slam_tpu.{mod}:\n  " + \
                         "\n  ".join(problems)


@pytest.mark.parametrize("rel", _jax_modules())
def test_class_members_exist(rel):
    """Every public method, property and class attribute (an enum's
    members) of a public JAX class exists on the port's class."""
    mod = _dotted(rel)
    classes = class_api(os.path.join(JAX_PKG, rel))

    def has_member(cls, member):
        api = classes.get(cls)
        return api is not None and member in (
            set(api["methods"]) | api["properties"] | api["attributes"])

    stale = _stale(MEMBER_EXCLUDED, mod, has_member)
    assert not stale, f"{mod}: MEMBER_EXCLUDED lists what JAX no longer " \
                      f"has: {stale}"
    missing = []
    for cls, api in sorted(classes.items()):
        if cls in EXCLUDED.get(mod, {}):
            continue
        port_cls = _port_object(mod, cls)
        names = set(api["methods"]) | api["properties"] | api["attributes"]
        for name in sorted(n for n in names if not n.startswith("_")):
            if (mod, cls, name) in MEMBER_EXCLUDED:
                continue
            if not hasattr(port_cls, name):
                kind = ("property" if name in api["properties"] else
                        "method" if name in api["methods"] else "attribute")
                missing.append(f"{cls}.{name} ({kind})")
    assert not missing, f"modular_slam_tpu.{mod}: the port's classes lack " \
                        f"{missing}"


def _port_fields(port_cls):
    """[(name, default or Parameter.empty)] of a NamedTuple or dataclass;
    a dataclass field with a default factory gives the factory."""
    if dataclasses.is_dataclass(port_cls):
        return [(f.name,
                 f.default if f.default is not dataclasses.MISSING else
                 f.default_factory
                 if f.default_factory is not dataclasses.MISSING else
                 inspect.Parameter.empty)
                for f in dataclasses.fields(port_cls)]
    defaults = getattr(port_cls, "_field_defaults", {})
    return [(n, defaults.get(n, inspect.Parameter.empty))
            for n in getattr(port_cls, "_fields", ())]


def _factory(node):
    """`dataclasses.field(default_factory=X)` -> the node of X, else None."""
    if isinstance(node, ast.Call) and ast.unparse(node.func).split(
            ".")[-1] == "field":
        for kw in node.keywords:
            if kw.arg == "default_factory":
                return kw.value
    return None


@pytest.mark.parametrize("rel", _jax_modules())
def test_record_fields_extend_jax(rel):
    """A JAX NamedTuple's or dataclass's fields are a prefix of the
    port's, with equal defaults, and the port's extra fields have
    defaults, so a JAX-style positional construction builds the port's."""
    mod = _dotted(rel)
    problems = []
    for cls, api in sorted(class_api(os.path.join(JAX_PKG, rel)).items()):
        if not api["record"] or cls in EXCLUDED.get(mod, {}):
            continue
        port_cls = _port_object(mod, cls)
        jnames = [n for n, _ in api["fields"]]
        pfields = _port_fields(port_cls)
        pnames = [n for n, _ in pfields]
        if pnames[:len(jnames)] != jnames:
            problems.append(f"{cls}: JAX's fields {jnames} are not a prefix "
                            f"of the port's {pnames}")
            continue
        for name, default in pfields[len(jnames):]:
            if default is inspect.Parameter.empty:
                problems.append(f"{cls}.{name}: a field JAX lacks, with no "
                                f"default")
        for (name, jdefault), (_, pdefault) in zip(api["fields"], pfields):
            factory = _factory(jdefault)
            problem = _default_problem(
                mod, f"{cls}.{name}", factory if factory is not None
                else jdefault, pdefault)
            if problem:
                problems.append(problem)
    assert not problems, f"modular_slam_tpu.{mod}:\n  " + \
                         "\n  ".join(problems)


def test_member_and_field_readers_see_every_kind():
    """The class and signature readers find what they are meant to find:
    properties, methods, an enum's members, inherited methods, record
    fields with their defaults, and `__init__` among the signatures."""
    types_api = class_api(os.path.join(JAX_PKG, "types.py"))
    assert "capacity" in types_api["Keypoints"]["properties"]
    assert types_api["Keypoints"]["record"]
    tracker = class_api(os.path.join(JAX_PKG, "frontend", "tracker.py"))
    fields = dict(tracker["TrackState"]["fields"])
    assert fields["ref_kf"] is None
    assert ast.unparse(fields["since_kf"]) == "None"
    engine = class_api(os.path.join(JAX_PKG, "engine.py"))
    assert "SUCCESS" in engine["SlamResult"]["attributes"]
    assert "process" in engine["SlamSystem"]["methods"]
    assert not engine["SlamSystem"]["record"]
    scenes = class_api(os.path.join(JAX_PKG, "eval", "synthetic.py"))
    assert "render" in scenes["PlaneSceneGenerator"]["methods"]
    config = class_api(os.path.join(JAX_PKG, "config.py"))
    assert _factory(dict(config["SlamConfig"]["fields"])["camera"]) \
        is not None
    defs = def_api(os.path.join(JAX_PKG, "engine.py"))
    assert {"SlamSystem.__init__", "make_slam_step",
            "SlamSystem.process"} <= set(defs)
