"""Tests of the benchmark itself (``benchmark/``), on the CPU:

    python -m pytest benchmark/tests -q

and, on a machine with a card, the ones marked ``card`` as well:

    python -m pytest benchmark/tests -q -m card
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where torch sees none")


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the benchmark on the card")
    return "cuda:0"


@pytest.fixture
def tmp_env(tmp_path, monkeypatch):
    """A TMPDIR of the test's own for the jobs."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path


def bench_json_with(cell: str, where: Path) -> Path:
    """A copy of BENCHMARK.json in ``where`` that has an entry for ``cell``,
    made from its workload file where BENCHMARK.json has none: a cell kept
    as files for a later benchmark still runs in these tests."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if cell not in {w["name"] for w in spec["workloads"]}:
        w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
        spec["workloads"].append({"name": cell, "config": w["config"],
                                  "traffic": cell.split(".", 1)[1],
                                  "chips": 1, "why": w["why"]})
    out = where / "BENCHMARK.json"
    out.write_text(json.dumps(spec))
    return out
