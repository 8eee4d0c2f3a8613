"""The port's copies of fqtool_tpu's jax-free modules stay equal to their
originals.

fqtool_tpu_torch carries its own copies of ``config/``, ``io/``,
``native/fastq_core.cpp`` and the ``host/`` modules, so that it imports
nothing of fqtool_tpu.  Each copy is its original with a header
comment ("Copy of fqtool_tpu/...") put in front, so a fix made on one side
only fails here.  ``host/tracing.py`` is the named exception: the copy drops
the JAX ``device_profile`` and the ``_PROFILE_DIR`` it reads, and has its own
module docstring, so it is compared as syntax trees with those left out.
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
    "host/report_json.py", "host/report_html.py"]
TRACING = "host/tracing.py"
TRACING_DROPPED = {"device_profile", "_PROFILE_DIR"}


def _comment(rel: str) -> str:
    return "//" if rel.endswith(".cpp") else "#"


def test_every_copy_is_listed():
    found = set()
    for path in (REPO / "fqtool_tpu_torch").rglob("*"):
        if path.suffix in (".py", ".cpp"):
            rel = str(path.relative_to(REPO / "fqtool_tpu_torch"))
            if path.read_text().startswith(f"{_comment(rel)} Copy of fqtool_tpu/"):
                found.add(rel)
    assert found == set(COPIES) | {TRACING}


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


def _body(text: str, drop=frozenset()) -> list:
    """ast.dump of each top-level statement after the module docstring,
    without functions or assignments named in ``drop``."""
    body = ast.parse(text).body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]
    names = lambda n: ({n.name} if isinstance(n, ast.FunctionDef) else  # noqa: E731
                       {getattr(t, "id", None) for t in n.targets}
                       if isinstance(n, ast.Assign) else set())
    return [ast.dump(n) for n in body if not names(n) & drop]


def test_tracing_copy_is_the_original_without_device_profile():
    orig = (REPO / "fqtool_tpu" / TRACING).read_text()
    copy = (REPO / "fqtool_tpu_torch" / TRACING).read_text()
    assert copy.startswith(f"# Copy of fqtool_tpu/{TRACING}")
    assert _body(copy) == _body(orig, TRACING_DROPPED)
