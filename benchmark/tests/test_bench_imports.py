"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: by an ``ast`` scan of every file
under ``benchmark/``, and by an import hook while a tiny cell runs.  Module
names are compared by their whole top-level name, since the program's name
begins with the JAX package's."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from conftest import BENCH, ROOT, bench_json_with

FORBIDDEN = {"jax", "jaxlib", "flax", "fqtool_tpu"}
PROGRAM = "fqtool_tpu_torch"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    got = top_level_imports(path)
    assert not got & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert PROGRAM not in got


HOOK = textwrap.dedent("""
    import sys
    REFUSED = set(sys.argv[1].split(","))

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path[:0] = [sys.argv[2], sys.argv[3]]
    """)


def run_hooked(refused, body, tmp_path):
    script = tmp_path / "hooked.py"
    script.write_text(HOOK + textwrap.dedent(body))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    return subprocess.run([sys.executable, str(script), ",".join(refused),
                           str(BENCH), str(ROOT)], capture_output=True,
                          text=True, timeout=600, env=env)


@pytest.mark.parametrize("cell", ["pe_merge_corr.cfdna", "pe_readme.small_sample"])
def test_a_cell_runs_with_jax_refused(cell, tmp_path):
    spec = bench_json_with(cell, tmp_path)
    p = run_hooked(FORBIDDEN, f"""
        import pathlib
        import run
        run.set_environment(False, "cpu")
        res = run.run_cell(run.load_cell("{cell}", pathlib.Path("{spec}")), 11,
                           0.0, False, device="cpu", job_pairs=2000)
        assert res["checks"]["records_differ"]["value"] == 0, res
        import child, check, readers
        for m in ("throughput", "dispatch_s", "device_idle"):
            run.reader(m)
        print("ok")
        """, tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("ok")


def test_the_reference_runs_with_the_program_refused(tmp_path):
    p = run_hooked(FORBIDDEN | {PROGRAM}, """
        import json
        from reference.pe import expected
        from traffic.pairs import PairLaw, make
        cfg = json.load(open(sys.argv[2] + "/configs/pe_readme.json"))
        ref = expected(make(PairLaw(), 2000, 3), cfg, "cpu")
        assert ref.stream_bytes("out1") and ref.report()["FilterResult"]
        assert not any(m.split(".")[0] == "fqtool_tpu_torch" for m in sys.modules)
        print("ok")
        """, tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().endswith("ok")


@pytest.mark.parametrize("name", sorted(FORBIDDEN))
def test_a_job_process_holding_jax_is_refused(name, tmp_path, monkeypatch):
    """A cell whose jobs are processes of their own: a job's process that
    holds a refused module, here loaded at its start-up, fails the run."""
    import run

    site = tmp_path / "site"
    (site / name).mkdir(parents=True)
    (site / name / "__init__.py").write_text("")
    (site / "sitecustomize.py").write_text(f"import {name}\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    run.set_environment(False, "cpu")
    with pytest.raises(run.BenchError, match=f"job's process: {name}"):
        cell = "pe_readme.small_sample"
        run.run_cell(run.load_cell(cell, bench_json_with(cell, tmp_path)), 11,
                     0.0, False, device="cpu", job_pairs=2000)
