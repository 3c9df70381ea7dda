"""Nothing under ocbench/ imports JAX or the JAX package, and the reference
imports nothing of the program, compared by whole top-level module names
(the program's name begins with the JAX package's)."""

import ast
import os

import pytest

OCBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "opencalibration_tpu"}


def imported_top_levels(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources(sub=""):
    root = os.path.join(OCBENCH, sub)
    return sorted(os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, OCBENCH))
def test_no_jax(path):
    assert not imported_top_levels(path) & JAX


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: os.path.relpath(p, OCBENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_top_levels(path) & (JAX | {"opencalibration_tpu_torch"})
    assert imported_top_levels(path) <= {"__future__", "numpy", "torch", "ocbench"}
    with open(path) as f:
        for node in ast.walk(ast.parse(f.read())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("ocbench"):
                assert node.module.startswith("ocbench.reference")


def test_the_guard_compares_whole_names():
    from ocbench import cell as C

    assert imported_top_levels.__name__  # the scan above; the run's guard below
    import sys

    before = set(sys.modules)
    assert "opencalibration_tpu_torch" not in C.JAX_NAMES
    sys.modules.setdefault("opencalibration_tpu_torch_probe", object())
    try:
        assert "opencalibration_tpu_torch_probe" not in C.jax_modules()
    finally:
        if "opencalibration_tpu_torch_probe" not in before:
            del sys.modules["opencalibration_tpu_torch_probe"]
