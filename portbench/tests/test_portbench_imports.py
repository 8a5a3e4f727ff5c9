"""Nothing under portbench/ imports JAX or the JAX package, and nothing
under portbench/reference/ imports the port or the harness. Top-level
module names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _files(sub=""):
    out = []
    for dirpath, _, names in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _top_names(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _files(), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_jax_package(path):
    assert not _top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", _files("reference"), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_names(path) & {"repro_torch", "portbench", "jax", "repro"}


def test_the_check_compares_whole_names():
    from portbench.harness import loaded_forbidden
    assert loaded_forbidden(["repro_torch", "repro_torch.core", "reproducible", "jaxtyping"]) == []
    assert loaded_forbidden(["repro.core.arena", "jax._src", "numpy"]) == ["jax", "repro"]
