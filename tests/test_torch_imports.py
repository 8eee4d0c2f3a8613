"""No source of the port imports the JAX package ``fqtool_tpu`` (or JAX).

Parses, with ``ast``, every ``.py`` under ``fqtool_tpu_torch/``, plus
``chip_smoke.py``, ``overlap_ab.py``, ``cli_ab.py`` and the ``tests/``
helpers they import
(followed through their own relative imports), and fails on any import of ``fqtool_tpu``,
``fqtool_tpu.*``, ``jax`` or ``jaxlib``: ``import`` and ``from`` statements
anywhere in the file, and ``importlib.import_module`` / ``__import__`` calls
with a constant name.  Complements the import hook of
``test_torch_no_jax.py``, which sees only the paths a run takes.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("fqtool_tpu", "jax", "jaxlib")
SCRIPTS = [REPO / "chip_smoke.py", REPO / "overlap_ab.py", REPO / "cli_ab.py"]


def _imports(tree: ast.AST):
    """(line, absolute module name or None for relative) of every import."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, node.module if node.level == 0 else None
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def _smoke_helpers():
    """tests/*.py that the scripts of SCRIPTS import, and what
    those import in turn from tests/ (relative imports)."""
    todo = list(SCRIPTS)
    seen = set()
    while todo:
        path = todo.pop()
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level == 0 and (node.module or "").startswith("tests."):
                mod = node.module.split(".", 1)[1]
            elif node.level == 1 and path.parent.name == "tests" and node.module:
                mod = node.module
            else:
                continue
            helper = REPO / "tests" / f"{mod}.py"
            if helper not in seen:
                seen.add(helper)
                todo.append(helper)
    return sorted(seen | {REPO / "tests" / "__init__.py"})


SOURCES = sorted((REPO / "fqtool_tpu_torch").rglob("*.py")) \
    + SCRIPTS + _smoke_helpers()


def test_the_scan_sees_the_port_and_the_smoke_helpers():
    rel = {str(p.relative_to(REPO)) for p in SOURCES}
    assert {"fqtool_tpu_torch/main.py", "fqtool_tpu_torch/config/cli.py",
            "fqtool_tpu_torch/io/fastq.py", "fqtool_tpu_torch/host/tracing.py",
            "fqtool_tpu_torch/dist/multihost.py", "fqtool_tpu_torch/dist/ingest.py",
            "fqtool_tpu_torch/dist/sharding.py", "fqtool_tpu_torch/entry.py",
            "fqtool_tpu_torch/host/profile.py", "fqtool_tpu_torch/ops/kernel_lib.py",
            "fqtool_tpu_torch/ops/stats_cuda.py",
            "chip_smoke.py", "overlap_ab.py", "cli_ab.py", "tests/oracle.py",
            "tests/torch_pairs.py", "tests/torch_reads.py"} <= rel
    bad = ast.parse("import fqtool_tpu.ops\nfrom jax import numpy\n"
                    "importlib.import_module('fqtool_tpu.config')\n")
    assert [n for _, n in _imports(bad)] == ["fqtool_tpu.ops", "jax",
                                             "fqtool_tpu.config"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_source_imports_no_fqtool_tpu(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [(line, name) for line, name in _imports(tree)
           if name and name.split(".")[0] in BLOCKED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
