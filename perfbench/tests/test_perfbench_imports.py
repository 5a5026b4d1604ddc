"""The benchmark's import fence, read from its sources.

Nothing under ``perfbench/`` imports JAX or the JAX package (``repro``;
the port, ``repro_torch``, only begins with that name: top-level names are
compared whole), the references import nothing of the port, no file names
the JAX package's benchmark folder or its result files, and nothing calls
the port's kernel oracles or its test helpers.
"""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(BENCH.rglob("*.py"))
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def dotted_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def test_there_are_modules_to_read():
    assert BENCH / "run.py" in MODULES
    assert any(p.parent.name == "reference" for p in MODULES)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", [p for p in MODULES
                                  if p.parent.name == "reference"],
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    assert "repro_torch" not in top_level_imports(path)
    assert "perfbench" not in top_level_imports(path)


def test_no_file_names_the_jax_benchmarks():
    banned = ("bench" + "marks/", "BENCH" + "_")
    for path in sorted(p for p in BENCH.rglob("*") if p.is_file()
                       and "__pycache__" not in p.parts):
        text = path.read_text(errors="replace")
        assert not any(b in text for b in banned), path


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_nothing_calls_the_kernel_oracles_or_test_helpers(path):
    names = dotted_imports(path)
    assert not any(n.startswith("repro_torch.kernels.ref") for n in names)
    assert not {n.split(".")[0] for n in names} & {"tests", "conftest"}
    assert "kernels" + "/ref" not in path.read_text()
