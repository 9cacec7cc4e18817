"""The port's layering: an ``ast`` walk of every ``import`` and ``from``
statement of ``orion_kmer_tpu_torch/``, the ones inside functions
included.  The import graph has no cycle but {``cli``, ``server``} (the
server runs the CLI, and the CLI starts the server), and no module below
the engine imports it."""

import ast
from pathlib import Path

import pytest

import orion_kmer_tpu_torch

PKG = Path(orion_kmer_tpu_torch.__file__).resolve().parent
NAME = PKG.name


def _modules() -> dict[str, Path]:
    """Every module of the package by dotted name, relative to it (a
    package by its own name, its ``__init__`` left out)."""
    out = {}
    for path in PKG.rglob("*.py"):
        parts = path.relative_to(PKG).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


def _resolve(mod: str, is_pkg: bool, node: ast.ImportFrom) -> str | None:
    """The module a ``from`` statement names, relative to the package, or
    None where it lies outside."""
    if node.level == 0:
        target = node.module or ""
        if target != NAME and not target.startswith(NAME + "."):
            return None
        return target[len(NAME) + 1 :]
    base = mod.split(".") if mod else []
    if not is_pkg:
        base = base[:-1]
    base = base[: len(base) - (node.level - 1)]
    return ".".join(base + ([node.module] if node.module else []))


def _graph() -> dict[str, set[str]]:
    """module -> the package's modules it imports.  ``from X import n``
    names X and, where ``X.n`` is a module, that module; a package does
    not count as imported by its own submodules (Python has it already)."""
    mods = _modules()
    graph = {m: set() for m in mods}
    for mod, path in mods.items():
        is_pkg = path.name == "__init__.py"
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            targets = []
            if isinstance(node, ast.Import):
                targets = [a.name[len(NAME) + 1 :] for a in node.names if a.name.startswith(NAME + ".")]
            elif isinstance(node, ast.ImportFrom):
                base = _resolve(mod, is_pkg, node)
                if base is None:
                    continue
                targets = [base] + [f"{base}.{a.name}".lstrip(".") for a in node.names]
            for t in targets:
                ancestor = mod == t or mod.startswith(t + ".") if t else True
                if t in mods and not ancestor:
                    graph[mod].add(t)
    return graph


def _cycles(graph: dict[str, set[str]]) -> list[set[str]]:
    """The strongly connected components of more than one module."""
    reach = {}
    for start in graph:
        seen, todo = set(), [start]
        while todo:
            for nxt in graph[todo.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    todo.append(nxt)
        reach[start] = seen
    out = []
    for m in graph:
        comp = {m} | {o for o in reach[m] if m in reach[o]}
        if len(comp) > 1 and comp not in out:
            out.append(comp)
    return out


def test_the_walk_sees_lazy_imports():
    """The walk finds the imports made inside functions: the server's
    count table and the CLI's server."""
    graph = _graph()
    assert "engine" in graph["server"] and "server" in graph["cli"] and "cli" in graph["server"]


def test_the_only_import_cycle_is_cli_and_server():
    assert _cycles(_graph()) == [{"cli", "server"}]


BELOW_ENGINE = ["db", "host", "keys", "staging", "table", "ops", "parallel"]


@pytest.mark.parametrize("layer", BELOW_ENGINE)
def test_a_layer_below_the_engine_does_not_import_it(layer):
    graph = _graph()
    members = [m for m in graph if m == layer or m.startswith(layer + ".")]
    assert members, f"no module {layer}"
    assert [m for m in members if "engine" in graph[m]] == []
