"""Every public name of the JAX package has a counterpart in the port.

Walks ``gradslam_tpu/`` and ``gradslam_torch/`` with ``ast`` (no module is
imported, so no JAX) and checks, module by module, that each public
top-level name of a JAX module and each public method of its classes has a
counterpart of the same name in the port module at the same path.

A JAX module's public names: its top-level functions, classes and
assignments without a leading ``_``, the names in its ``__all__``, and, in
an ``__init__.py`` with no ``__all__``, the names it imports from the
package; a class's public methods: those without a single leading ``_``
(dunder methods such as ``__getitem__`` and ``__matmul__`` count). A port
name counts as a counterpart however the port module binds it: defined,
assigned or imported.

``ALLOWED`` is the only exception: what is deliberately not ported, each
with why. What it lists is what is left of the port.

The signatures too: each public function and method the JAX module defines
with ``def`` is defined in the port module, and every parameter name of the
JAX definition is a parameter of the port's (the port may add its own, such
as ``device``); a JAX ``*args`` or ``**kwargs`` needs one in the port. A
port ``**kwargs`` passes names through only where ``PASS_THROUGH`` names the
definition that takes them.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
JAX_PKG, PORT_PKG = ROOT / "gradslam_tpu", ROOT / "gradslam_torch"

_TPU = "TPU-only plumbing (ROADMAP.md, 'Do not port the TPU-only plumbing')"
_PALLAS = "the Pallas kernel; its port is the hand CUDA kernel ops/csrc/knn.cu"
_HP = ("XLA precision arguments; the port's TF32 switches play their role "
       "(utils/precision.py: disable_tf32, fp32_products)")

# module path (relative to the package) -> {name: why}; "*" is the whole module
ALLOWED = {
    "ops/knn_pallas.py": {"*": _PALLAS},
    "ops/__init__.py": {
        "nn_points_pallas": _PALLAS,
        "get_knn_backend": f"{_TPU}: the XLA/Pallas backend switch",
        "set_knn_backend": f"{_TPU}: the XLA/Pallas backend switch",
    },
    "utils/cli.py": {"enable_compile_cache": f"{_TPU}: XLA's persistent compile cache"},
    "utils/__init__.py": {
        "enable_compile_cache": f"{_TPU}: XLA's persistent compile cache",
        "matmul_hp": _HP, "einsum_hp": _HP, "HIGHEST": _HP,
    },
    "utils/precision.py": {"matmul_hp": _HP, "einsum_hp": _HP, "HIGHEST": _HP},
    "slam/icpslam.py": {
        "ICPSLAM.__call__": "inherited from torch.nn.Module, which calls forward()",
    },
}


# port definition with **kwargs -> (module, definition) its kwargs reach
PASS_THROUGH = {
    ("slam/pointfusion.py", "PointFusion.__init__"): ("slam/icpslam.py", "ICPSLAM.__init__"),
}


def _public(name: str) -> bool:
    last = name.rsplit(".", 1)[-1]
    return not last.startswith("_") or (last.startswith("__") and last.endswith("__"))


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [t.id for t in targets if isinstance(t, ast.Name)]


def _all_list(value) -> set:
    """The string entries of an ``__all__`` expression (a list, or a sum
    with lists in it)."""
    if isinstance(value, ast.BinOp):
        return _all_list(value.left) | _all_list(value.right)
    if isinstance(value, (ast.List, ast.Tuple)):
        return {e.value for e in value.elts if isinstance(e, ast.Constant)}
    return set()


def bound_names(path: Path) -> tuple:
    """``(public API, every binding)`` of a module, with class methods as
    ``Class.method``."""
    tree = ast.parse(path.read_text())
    api, bound, imported, declared = set(), set(), set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names = [node.name]
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
            api.update(names)
            bound.update(names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _assigned(node):
                if name == "__all__":
                    declared = _all_list(node.value)
                else:
                    api.add(name)
                    bound.add(name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                bound.add(name)
                if isinstance(node, ast.ImportFrom) and node.level > 0 and name != "*":
                    imported.add(name)
    if declared is not None:
        api |= declared
    elif path.name == "__init__.py":
        api |= imported
    return {n for n in api if _public(n)}, bound


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_the_walk_sees_the_packages():
    assert "structures/pointclouds.py" in JAX_MODULES and len(JAX_MODULES) > 40
    api, _ = bound_names(JAX_PKG / "structures/pointclouds.py")
    assert {"Pointclouds", "Pointclouds.__getitem__", "Pointclouds.offset_"} <= api
    assert "Pointclouds._map_points" not in api


def test_the_allowlist_names_only_what_exists_and_is_missing():
    for module, names in ALLOWED.items():
        jax_api, _ = bound_names(JAX_PKG / module)
        port = PORT_PKG / module
        port_bound = bound_names(port)[1] if port.exists() else set()
        for name in names:
            if name == "*":
                assert not port.exists(), f"{module} is ported: take it out of ALLOWED"
                continue
            assert name in jax_api, f"ALLOWED names {module}:{name}, which JAX does not have"
            assert name not in port_bound, f"{module}:{name} is ported: take it out of ALLOWED"


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_jax_name_has_a_port_counterpart(module):
    allowed = ALLOWED.get(module, {})
    port = PORT_PKG / module
    if "*" in allowed:
        assert not port.exists(), f"gradslam_torch/{module} exists: take it out of ALLOWED"
        return
    assert port.exists(), f"gradslam_torch/{module} is missing"
    jax_api, _ = bound_names(JAX_PKG / module)
    _, port_bound = bound_names(port)
    missing = sorted(jax_api - set(allowed) - port_bound)
    assert not missing, f"gradslam_torch/{module} lacks {missing}"


def test_the_port_reports_the_jax_packages_version():
    import gradslam_torch

    tree = ast.parse((JAX_PKG / "version.py").read_text())
    (assign,) = [n for n in tree.body if isinstance(n, ast.Assign)]
    assert gradslam_torch.__version__ == ast.literal_eval(assign.value)
    assert "__version__" in gradslam_torch.__all__


def definitions(path: Path) -> dict:
    """The module's top-level functions and its classes' methods, as
    ``Class.method``, each with its argument node."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node.args
        elif isinstance(node, ast.ClassDef):
            out.update({f"{node.name}.{m.name}": m.args for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))})
    return out


def _names(args) -> set:
    return {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_jax_signature_is_accepted_by_the_port(module):
    port = PORT_PKG / module
    if "*" in ALLOWED.get(module, {}):
        return
    ours = definitions(port)
    gaps = []
    for name, theirs in definitions(JAX_PKG / module).items():
        if not _public(name) or name not in ours:
            continue  # a missing name is the test above's to report
        mine = ours[name]
        accepted = _names(mine)
        if mine.kwarg is not None and (module, name) in PASS_THROUGH:
            target_module, target = PASS_THROUGH[(module, name)]
            accepted |= _names(definitions(PORT_PKG / target_module)[target])
        missing = sorted(_names(theirs) - accepted)
        if theirs.vararg is not None and mine.vararg is None:
            missing.append("*" + theirs.vararg.arg)
        if theirs.kwarg is not None and mine.kwarg is None:
            missing.append("**" + theirs.kwarg.arg)
        if missing:
            gaps.append(f"{name} lacks {missing}")
    assert not gaps, f"gradslam_torch/{module}: " + "; ".join(gaps)
