"""What decides ``correct``: the outputs of the timed jobs against the plain
reference (``reference/``), and every job of the window against the one that
was checked.

Three numbers, each with the limit 0:

- ``records_differ``: records of the checked job's output streams that are
  missing, extra, or differ from the reference's;
- ``counters_differ``: numbers and strings of its JSON report (all but
  ``Software``) that are missing, extra, or differ from the reference's;
- ``jobs_differ``: jobs of the window whose output streams or report numbers
  are not those of the checked job (every job reads the same pairs).
"""

from __future__ import annotations

import gzip
import hashlib
import json
from pathlib import Path
from typing import Dict

from reference.records import records_differ

LIMITS = {"records_differ": 0, "counters_differ": 0, "jobs_differ": 0}


def flatten(obj, prefix: str = "") -> Dict[str, object]:
    """``{"a.b.0": leaf}`` of a JSON value."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(obj, list):
        out = {}
        for i, v in enumerate(obj):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: obj}


def report_numbers(path: Path) -> Dict[str, object]:
    rep = json.loads(Path(path).read_text())
    rep.pop("Software", None)
    return flatten(rep)


def counters_differ(got: Dict[str, object], want: Dict[str, object]) -> int:
    keys = set(got) | set(want)
    return sum(1 for k in keys if k not in got or k not in want
               or type(got[k]) is not type(want[k]) or got[k] != want[k])


def job_signature(job_dir: Path, streams: Dict[str, str]) -> tuple:
    """The digests of a job's output files and its report numbers."""
    digests = tuple(hashlib.sha1((job_dir / f).read_bytes()).hexdigest()
                    if (job_dir / f).exists() else None
                    for f in sorted(streams.values()))
    return digests, report_numbers(job_dir / "report.json")


def against_reference(job_dir: Path, streams: Dict[str, str], ref) -> dict:
    """``records_differ`` and ``counters_differ`` of one job's outputs."""
    recs = 0
    for stream, fname in streams.items():
        path = job_dir / fname
        got = gzip.decompress(path.read_bytes()) if path.exists() else b""
        recs += records_differ(got, ref.stream_bytes(stream))
    want = flatten(ref.report())
    got = report_numbers(job_dir / "report.json")
    return {"records_differ": recs, "counters_differ": counters_differ(got, want)}
