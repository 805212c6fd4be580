"""The port's module graph, read from its source with :mod:`ast`.

The layers point one way: normalizers → ops (the routers) → kernels (the
wrappers and their plain versions, with the formulas both share). Each
``import`` and ``from … import`` of the port at any depth of a file is an
edge; ``from stainx_tpu_torch import kernels`` is an edge to ``kernels``, and
the parent packages a dotted import runs on the way are not counted.

Imports nothing of the port, so it holds the graph as the files state it.
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path

import pytest

PACKAGE = "stainx_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent / PACKAGE
# The one edge allowed to close a cycle, and the one import allowed inside a
# function of ops/ or kernels/: parallel.distributed imports ops.reinhard,
# and reinhard_fit_sharded mirrors the JAX package's ops API.
SHARDED_FIT_EDGE = (f"{PACKAGE}.ops.reinhard", f"{PACKAGE}.parallel.distributed")
ROUTERS = tuple(f"{PACKAGE}.ops.{m}" for m in ("macenko", "reinhard", "histogram_matching"))


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _modules() -> dict[str, ast.Module]:
    return {_module_name(p): ast.parse(p.read_text(), str(p)) for p in sorted(ROOT.rglob("*.py"))}


def _targets(node: ast.AST, module: str, is_package: bool, known) -> list[str]:
    """The port's modules an import node names."""
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
        if node.level:
            base = module.split(".")
            base = base[: len(base) - node.level + (1 if is_package else 0)]
            source = ".".join(base + ([node.module] if node.module else []))
        else:
            source = node.module or ""
        names = [f"{source}.{a.name}" if f"{source}.{a.name}" in known else source
                 for a in node.names]
    else:
        return []
    out = []
    for name in names:
        while name and name not in known:
            name = name.rpartition(".")[0]
        if name:
            out.append(name)
    return out


@functools.cache
def _edges() -> list[tuple[str, str, bool]]:
    """``(importer, imported, inside a function)`` for every import of the
    port in the package."""
    modules = _modules()
    edges = []
    for name, tree in modules.items():
        is_package = (ROOT.parent / name.replace(".", "/") / "__init__.py").exists()
        stack = [(tree, False)]
        while stack:
            node, in_function = stack.pop()
            for target in _targets(node, name, is_package, modules):
                if target != name:
                    edges.append((name, target, in_function))
            inner = in_function or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                     ast.Lambda))
            stack.extend((child, inner) for child in ast.iter_child_nodes(node))
    return edges


def _cycle(graph: dict[str, set[str]]) -> list[str] | None:
    """A cycle of ``graph`` as a list of modules, or None."""
    state: dict[str, int] = {}

    def visit(node, path):
        state[node] = 1
        for nxt in sorted(graph.get(node, ())):
            if state.get(nxt) == 1:
                return path[path.index(nxt):] + [nxt] if nxt in path else [node, nxt]
            if nxt not in state:
                found = visit(nxt, path + [nxt])
                if found:
                    return found
        state[node] = 2
        return None

    for start in sorted(graph):
        if start not in state:
            found = visit(start, [start])
            if found:
                return found
    return None


def test_the_module_graph_is_acyclic():
    graph: dict[str, set[str]] = {}
    for src, dst, _ in _edges():
        if (src, dst) != SHARDED_FIT_EDGE:
            graph.setdefault(src, set()).add(dst)
    assert _cycle(graph) is None, " → ".join(_cycle(graph))


def test_no_kernel_module_imports_a_router():
    up = sorted({(src, dst) for src, dst, _ in _edges()
                 if src.startswith(f"{PACKAGE}.kernels") and dst in ROUTERS})
    assert up == []


def test_ops_and_kernels_import_the_port_at_module_level():
    inner = sorted({(src, dst) for src, dst, in_function in _edges()
                    if in_function and src.startswith((f"{PACKAGE}.ops", f"{PACKAGE}.kernels"))
                    and (src, dst) != SHARDED_FIT_EDGE})
    assert inner == []


@pytest.mark.parametrize("name", ["normalize_to_0_1", "_folds_range", "_finalize_range"])
def test_the_template_leaves_the_output_range_to_macenko(name):
    assert name not in (ROOT / "normalizers" / "_template.py").read_text()
