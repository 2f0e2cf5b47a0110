"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: ``pkr_tpu_torch`` is not ``pkr_tpu``), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "pkr_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "pkr_tpu_torch" not in top_level_imports(path)
    assert not top_level_imports(path) & FORBIDDEN


def test_the_check_compares_whole_names():
    assert "pkr_tpu" not in {"pkr_tpu_torch".split(".")[0]}
    assert top_level_imports(HERE / "build.py") >= {"torch", "numpy", "portbench"}
