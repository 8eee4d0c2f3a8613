"""The port's copies of fqtool_tpu's jax-free modules stay equal to their
originals.

fqtool_tpu_torch carries its own copies of ``config/``, ``io/``,
``native/fastq_core.cpp`` and the ``host/`` modules, so that it imports
nothing of fqtool_tpu.  Each copy is its original with a header
comment ("Copy of fqtool_tpu/...") put in front, so a fix made on one side
only fails here.  One copy is the named exception, compared as a syntax
tree with the dropped names left out and with its own module docstring:
``dist/multihost.py`` drops ``MultihostContext._init_jax`` (the
``jax.distributed.initialize`` call) and the statement that calls it.
``host/tracing.py`` is the port's own module, not a copy.
"""

from __future__ import annotations

import ast
import difflib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
COPIES = [
    "config/options.py", "config/cli.py",
    "io/native.py", "io/fastq.py", "io/headcache.py", "native/fastq_core.cpp",
    "host/nucleotidetree.py", "host/known_adapters.py", "host/evaluator.py",
    "host/names.py", "host/umi.py", "host/stats.py", "host/duplicate.py",
    "host/accounting.py", "host/ora_defer.py", "host/filterresult.py",
    "host/report_json.py", "host/report_html.py", "dist/ingest.py"]
# copy -> the names it drops from its original
TREE_COPIES = {"dist/multihost.py": {"_init_jax"}}


def _comment(rel: str) -> str:
    return "//" if rel.endswith(".cpp") else "#"


def test_every_copy_is_listed():
    found = set()
    for path in (REPO / "fqtool_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cpp"):
            rel = str(path.relative_to(REPO / "fqtool_tpu_torch"))
            if path.read_text().startswith(f"{_comment(rel)} Copy of fqtool_tpu/"):
                found.add(rel)
    assert found == set(COPIES) | set(TREE_COPIES)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original(rel):
    orig = (REPO / "fqtool_tpu" / rel).read_text()
    copy = (REPO / "fqtool_tpu_torch" / rel).read_text()
    head = copy[:len(copy) - len(orig)]
    c = _comment(rel)
    assert head.startswith(f"{c} Copy of fqtool_tpu/{rel}")
    assert all(line.startswith(c) for line in head.splitlines())
    assert copy.endswith(orig), "".join(difflib.unified_diff(
        orig.splitlines(True), copy[len(head):].splitlines(True),
        f"fqtool_tpu/{rel}", f"fqtool_tpu_torch/{rel}", n=1))


class _Drop(ast.NodeTransformer):
    """Removes functions, methods and assignments named in ``drop``, and
    statements that only call one of those names."""

    def __init__(self, drop):
        self.drop = drop

    def _named(self, node) -> set:
        if isinstance(node, ast.FunctionDef):
            return {node.name}
        if isinstance(node, ast.Assign):
            return {getattr(t, "id", None) for t in node.targets}
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            fn = node.value.func
            return {fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)}
        return set()

    def generic_visit(self, node):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list):
                setattr(node, field, [n for n in stmts if not self._named(n) & self.drop])
        return super().generic_visit(node)


def _body(text: str, drop=frozenset()) -> list:
    """ast.dump of each top-level statement after the module docstring,
    without the functions, methods, assignments and calls named in
    ``drop``."""
    body = _Drop(set(drop)).visit(ast.parse(text)).body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]
    return [ast.dump(n) for n in body]


@pytest.mark.parametrize("rel", sorted(TREE_COPIES))
def test_copy_is_its_original_without_the_dropped_names(rel):
    orig = (REPO / "fqtool_tpu" / rel).read_text()
    copy = (REPO / "fqtool_tpu_torch" / rel).read_text()
    assert copy.startswith(f"# Copy of fqtool_tpu/{rel}")
    assert _body(copy) == _body(orig, TREE_COPIES[rel])
    # the dropped names are really in the original, and gone from the copy
    assert _body(orig) != _body(orig, TREE_COPIES[rel])
    assert _body(copy) == _body(copy, TREE_COPIES[rel])
