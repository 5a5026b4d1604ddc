"""The ring round's program layer points one way (`repro_torch.api`).

``runner`` drives a horizon through the chunk programs of ``program``,
built from the rounds the backends make (``backends``, ``shard_node``);
``backends`` builds the captured round of ``round_graph``. Each module's
imports, at any depth of the file (a function's own imports too), reach
only the modules below it, and no module takes another's private name,
by import or by attribute. A backend builds rounds and nothing else.
"""
from __future__ import annotations

import ast
import pathlib

import pytest

API = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" \
    / "api"
PKG = "repro_torch.api"
# the modules of the layer each one may import
BELOW = {
    "runner": {"backends", "shard_node", "program"},
    "backends": {"shard_node", "round_graph", "program"},
    "shard_node": {"program"},
    "round_graph": {"program"},
    "program": set(),
}


def _uses(name: str) -> list:
    """(module of the layer, the name taken from it or None) of every
    import in ``name``'s file, and of every ``module._name`` attribute on
    a module of the layer that the file binds to a name."""
    tree = ast.parse((API / f"{name}.py").read_text())
    uses, bound = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                if node.module == PKG and alias.name in BELOW:
                    uses.append((alias.name, None))
                    bound[alias.asname or alias.name] = alias.name
                elif node.module.startswith(PKG + "."):
                    mod = node.module[len(PKG) + 1:]
                    if mod in BELOW:
                        uses.append((mod, alias.name))
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.startswith(PKG + "."):
                    mod = alias.name[len(PKG) + 1:]
                    if mod in BELOW:
                        uses.append((mod, None))
                        if alias.asname:
                            bound[alias.asname] = mod
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in bound):
            uses.append((bound[node.value.id], node.attr))
    return uses


@pytest.mark.parametrize("name", sorted(BELOW))
def test_a_module_imports_only_the_layers_below_it(name):
    reached = {mod for mod, _ in _uses(name)} - {name}
    assert reached <= BELOW[name], \
        f"{name} imports {sorted(reached - BELOW[name])}"


@pytest.mark.parametrize("name", sorted(BELOW))
def test_no_module_takes_another_modules_private_name(name):
    private = sorted({f"{mod}.{attr}" for mod, attr in _uses(name)
                      if mod != name and attr and attr.startswith("_")
                      and not attr.startswith("__")})
    assert not private, f"{name} takes {private}"


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_a_backend_builds_rounds_and_nothing_else(backend):
    pytest.importorskip("torch")
    from repro_torch.api import BACKENDS
    methods = {k for k, v in vars(type(BACKENDS.build(backend))).items()
               if callable(v) and not k.startswith("_")}
    assert methods == {"make_round_program", "make_local_round_fn"}
