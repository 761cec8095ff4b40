"""The port's public surface against the JAX package's, read from the sources.

Both packages are parsed with `ast`; nothing of either is imported, so this
file needs no JAX.  It asserts, for `frenetix_tpu/` against
`frenetix_tpu_torch/`:

- every module has a counterpart at the same path, or sits on
  `MODULES_WITHOUT_COUNTERPART`;
- every public name of a JAX module (its `__all__`, else its top-level public
  defs, classes and constants, and in a package `__init__` what it
  re-exports) exists in the counterpart, or sits on `NAMES_WITHOUT_COUNTERPART`;
- every public member of a class present in both exists in the port's class
  (its body or a base class of the same module);
- every parameter name of a public function or method present in both is
  accepted by the port's function (by name, or by its `**kwargs`), or sits on
  `PARAMETER_RENAMES`.

The three dicts are the complete list of what the port deliberately lacks,
each entry with its reason; ROADMAP's "Leave without a counterpart" list is
written from them.  Entries that no longer apply fail too, so the lists stay
true.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "frenetix_tpu", ROOT / "frenetix_tpu_torch"

MODULES_WITHOUT_COUNTERPART = {
    "native.py": "loads the C++ helper library of the JAX package; the port "
                 "runs the NumPy routes it falls back to",
    "models/onnx_jax.py": "the ONNX interpreter in JAX; the port's is "
                          "models/onnx_torch.py",
    "ops/pallas_interp.py": "the Pallas TPU kernel K1; the port's is the CUDA "
                            "kernel csrc/table_interp.cu behind ops/table_interp.py",
    "planner/numpy_backend.py": "a scalar NumPy oracle of the cycle for the JAX "
                                "tests; the port's tests hold against JAX directly",
    "utils/aot_cache.py": "ahead-of-time export of XLA programs, which persists "
                          "them across processes; the in-process compile cache's "
                          "counterpart is utils/compiled.py",
    "utils/jax_cache.py": "the persistent XLA compilation cache, kept across "
                          "processes; the in-process compile cache's counterpart "
                          "is utils/compiled.py",
    "utils/timers.py": "ExecTimer, a host-clock timer that nothing read; the port's "
                       "spans and counters are utils/tracing.py, on the profiler's "
                       "clock",
}

NAMES_WITHOUT_COUNTERPART = {
    ("geometry/frenet.py", "interp_weights"):
        "the two-hot matrix form of the table lookup for the TPU's matrix "
        "unit; K1 (geometry.frenet.interp_columns) replaces it",
    ("parallel/mesh.py", "CTX_IN_AXES"): "jax.vmap in_axes of the stacked context; "
                                         "the port batches along leading axes",
    ("parallel/mesh.py", "CTX_PSPECS"): "shard_map PartitionSpecs; the port's mesh "
                                        "splits rows over torch.distributed ranks",
    ("parallel/mesh.py", "GRID_IN_AXES"): "jax.vmap in_axes of the stacked reach "
                                          "grids",
}

PARAMETER_RENAMES = {
    ("ops/costs.py", "simpson_uniform", "axis"): "PyTorch names the axis `dim`",
    ("utils/sim_logging.py", "SimulationLogger.log_evaluation", "df"):
        "takes the port's MetricTable as `table`: the card's machine has no pandas",
    ("risk/harm.py", "meta_from_footprint", "xp"):
        "a NumPy / jax.numpy switch; the port computes on the inputs' device",
    ("risk/harm.py", "meta_from_footprint", "dtype"):
        "the port keeps the dtype of its inputs",
    ("sim/prediction.py", "to_device", "jnp"):
        "the array module; the port takes `device` and `dtype`",
}


def _modules(pkg):
    return {p.relative_to(pkg).as_posix(): p for p in sorted(pkg.rglob("*.py"))}


JAX_MODULES, PORT_MODULES = _modules(JAX_PKG), _modules(PORT_PKG)
SHARED = sorted(set(JAX_MODULES) & set(PORT_MODULES))


def _statements(body):
    """Top-level statements, looking into `if` and `try` blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _statements(node.body)
            for handler in node.handlers:
                yield from _statements(handler.body)
            yield from _statements(node.orelse)
            yield from _statements(node.finalbody)
        else:
            yield node


def _targets(node):
    if isinstance(node, ast.Assign):
        for target in node.targets:
            for leaf in ast.walk(target):
                if isinstance(leaf, ast.Name):
                    yield leaf.id
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and isinstance(node.target, ast.Name):
        yield node.target.id


def _bindings(tree):
    """Every name a module binds at top level: name → its node."""
    out = {}
    for node in _statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = node
        else:
            for name in _targets(node):
                out[name] = node
    return out


def _public_names(tree, is_init):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    names = []
    for node in _statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.ImportFrom) and is_init:
            names.extend(alias.asname or alias.name for alias in node.names)
        else:
            names.extend(_targets(node))
    return [n for n in names if not n.startswith("_")]


def _members(cls):
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        else:
            out.update(_targets(node))
    return out


def _parameters(fn):
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    return names, args.kwarg is not None


def _parse(rel):
    return (ast.parse(JAX_MODULES[rel].read_text()),
            ast.parse(PORT_MODULES[rel].read_text()))


def _functions(rel):
    """(qualified name, JAX def, port def) of every public function and
    method (and `__init__`) defined in both modules."""
    jtree, ttree = _parse(rel)
    jb, tb = _bindings(jtree), _bindings(ttree)
    for name, jnode in jb.items():
        tnode = tb.get(name)
        if name.startswith("_") or tnode is None:
            continue
        if isinstance(jnode, ast.FunctionDef) and isinstance(tnode, ast.FunctionDef):
            yield name, jnode, tnode
        elif isinstance(jnode, ast.ClassDef) and isinstance(tnode, ast.ClassDef):
            port_methods = {n.name: n for n in tnode.body if isinstance(n, ast.FunctionDef)}
            for member in jnode.body:
                if (isinstance(member, ast.FunctionDef) and member.name in port_methods
                        and (not member.name.startswith("_") or member.name == "__init__")):
                    yield f"{name}.{member.name}", member, port_methods[member.name]


def test_every_module_has_a_counterpart():
    missing = sorted(set(JAX_MODULES) - set(PORT_MODULES) - set(MODULES_WITHOUT_COUNTERPART))
    assert not missing, f"JAX modules without a port counterpart: {missing}"
    stale = sorted(set(MODULES_WITHOUT_COUNTERPART) - (set(JAX_MODULES) - set(PORT_MODULES)))
    assert not stale, f"exempt modules that exist in the port or left JAX: {stale}"


@pytest.mark.parametrize("rel", SHARED)
def test_public_names_exist_in_the_port(rel):
    jtree, ttree = _parse(rel)
    port = _bindings(ttree)
    wanted = _public_names(jtree, rel.endswith("__init__.py"))
    missing = [n for n in wanted if n not in port and (rel, n) not in NAMES_WITHOUT_COUNTERPART]
    assert not missing, f"{rel}: public names missing in the port: {missing}"
    for (mod, name) in NAMES_WITHOUT_COUNTERPART:
        if mod == rel:
            assert name in wanted and name not in port, f"stale exemption {mod}::{name}"


@pytest.mark.parametrize("rel", SHARED)
def test_class_members_exist_in_the_port(rel):
    jtree, ttree = _parse(rel)
    jb, tb = _bindings(jtree), _bindings(ttree)
    missing = []
    for name, jnode in jb.items():
        tnode = tb.get(name)
        if name.startswith("_") or not (isinstance(jnode, ast.ClassDef)
                                        and isinstance(tnode, ast.ClassDef)):
            continue
        port = _members(tnode)
        for base in tnode.bases:
            if isinstance(base, ast.Name) and isinstance(tb.get(base.id), ast.ClassDef):
                port |= _members(tb[base.id])
        missing += [f"{name}.{m}" for m in sorted(_members(jnode) - port)
                    if not m.startswith("_")]
    assert not missing, f"{rel}: class members missing in the port: {missing}"


@pytest.mark.parametrize("rel", SHARED)
def test_parameters_are_accepted_by_the_port(rel):
    refused = []
    for qualname, jfn, tfn in _functions(rel):
        port, var_kw = _parameters(tfn)
        refused += [f"{qualname}({p})" for p in _parameters(jfn)[0]
                    if p not in port and not var_kw
                    and (rel, qualname, p) not in PARAMETER_RENAMES]
    assert not refused, f"{rel}: JAX parameters the port refuses: {refused}"


def test_parameter_renames_are_still_renames():
    for rel, qualname, param in PARAMETER_RENAMES:
        found = {q: (j, t) for q, j, t in _functions(rel)}
        assert qualname in found, f"stale rename {rel}::{qualname}"
        jfn, tfn = found[qualname]
        assert param in _parameters(jfn)[0] and param not in _parameters(tfn)[0], \
            f"stale rename {rel}::{qualname}({param})"


def test_every_exemption_carries_a_reason():
    for table in (MODULES_WITHOUT_COUNTERPART, NAMES_WITHOUT_COUNTERPART, PARAMETER_RENAMES):
        for key, reason in table.items():
            assert isinstance(reason, str) and len(reason.split()) >= 3, key
