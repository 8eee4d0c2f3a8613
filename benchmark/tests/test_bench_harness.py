"""The harness is driven by each cell's own files: a cell with a generator and
a reference of its own (here a single-end one) runs by new files alone, and
the accepted paired-end cells read the same work as before the harness took
its unit, inputs and overlap scans from those files."""

from __future__ import annotations

import filecmp
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, bench_json_with
import run

SEED = 2**33 + 21
PAIRS = 20_000  # the size of test_bench_run.py's runs

# The files a later change would add for a single-end cell, all toys.  The
# stub reference gives back the program's own CPU output for the job's input,
# so the test checks the harness's plumbing only, never the program: a real
# single-end reference works the outputs out on its own.
TOY_FILES = {
    "traffic/toy_reads.py": '''
        """A toy one-input generator: read 1 of the pairs generator's pairs."""
        import gzip

        from traffic import pairs

        UNIT = "reads"
        INPUTS = ("r1.fq.gz",)


        class Reads:
            def __init__(self, law, fastq: bytes):
                self.law, self.fastq = law, fastq

            @property
            def count(self) -> int:
                return self.fastq.count(b"\\n") // 4

            @property
            def bases(self) -> int:
                return self.count * self.law.read_len


        def law(params):
            return pairs.law(params)


        def make(law, n, seed):
            p = pairs.make(law, n, seed, threads=1)
            return Reads(law, pairs.fastq_bytes(law, p.seq1, p.qual1, 1, 0))


        def make_and_write(law, n, seed, *paths):
            (path,) = paths
            reads = make(law, n, seed)
            data = gzip.compress(reads.fastq, 1)
            with open(path, "wb") as f:
                f.write(data)
            return reads, len(data)
        ''',
    "reference/toy_se.py": '''
        """A stub reference: the program's own CPU output for the same input
        (the plumbing test's, not a reference of the program)."""
        import gzip
        import json
        import tempfile
        from pathlib import Path

        import run


        class Output:
            def __init__(self, d: Path, streams: dict):
                self.streams = {s: gzip.decompress((d / f).read_bytes())
                                for s, f in streams.items()}
                self.rep = json.loads((d / "report.json").read_text())
                self.rep.pop("Software")

            def stream_bytes(self, name):
                return self.streams[name]

            def report(self):
                return self.rep


        def expected(records, config, device, broken=None):
            from fqtool_tpu_torch.main import main

            with tempfile.TemporaryDirectory() as d:
                d = Path(d)
                r1 = d / "r1.fq.gz"
                r1.write_bytes(gzip.compress(records.fastq, 1))
                if main(run.job_argv(config, d, [r1])) != 0:
                    raise RuntimeError("the program failed on the stub's input")
                return Output(d, config["streams"])
        ''',
    "configs/toy_se.json": json.dumps({
        "name": "toy_se",
        "argv": ["-i", "{r1}", "-o", "{dir}/out1.fq.gz",
                 "-J", "{dir}/report.json", "-H", "{dir}/report.html"],
        "streams": {"out1": "out1.fq.gz"}, "reference": "toy_se",
        "read_len": 150}),
    "workloads/toy_se.reads.json": json.dumps({
        "config": "toy_se", "mode": "inprocess", "control": "none",
        "job_reads": 3000,
        "traffic": {"generator": "toy_reads", "read_len": 150, "qual_bins": []},
        "why": "the harness's plumbing for a one-input cell"}),
}

CELL_SCRIPT = """
    import json, os, sys
    from pathlib import Path

    sys.path.insert(0, sys.argv[1])
    import run

    run.set_environment(False, "cpu")
    linked = []
    real_link = os.link

    def link(src, dst):
        linked.append(Path(dst).name)
        real_link(src, dst)
    os.link = link
    records = []
    real_reader = run.reader

    def reader(name):
        def read(rec):
            records.append(rec)
            return real_reader(name)(rec)
        return read
    run.reader = reader
    res = run.run_cell(run.load_cell("toy_se.reads"), int(sys.argv[2]), 0.0,
                       False, device="cpu")
    rec = records[0]
    print(json.dumps({"result": res, "record": rec, "linked": linked,
                      "read": {m: real_reader(m)(rec) for m in (
                          "throughput", "overlap_kernel_roofline",
                          "overlap_kernel_roofline.cfdna")}}))
    """


def files_under(d: Path) -> dict:
    return {p.relative_to(d).as_posix(): p for p in d.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_single_end_cell_runs_by_new_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in TOY_FILES.items():
        (copy / "benchmark" / rel).write_text(textwrap.dedent(text).lstrip())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy_se", "source": "a test",
                            "file": "benchmark/configs/toy_se.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy_se.reads", "config": "toy_se",
                              "traffic": "reads", "chips": 1, "why": "a test"})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    # the copy differs from benchmark/ by additions only
    have, got = files_under(BENCH), files_under(copy / "benchmark")
    assert set(got) - set(have) == set(TOY_FILES)
    assert set(have) <= set(got)
    assert all(filecmp.cmp(have[f], got[f], shallow=False) for f in have)

    script = tmp_path / "run_toy_cell.py"
    script.write_text(textwrap.dedent(CELL_SCRIPT))
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=str(ROOT))
    p = subprocess.run([sys.executable, str(script), str(copy / "benchmark"),
                        str(SEED)], capture_output=True, text=True, timeout=600,
                       env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.splitlines()[-1])
    res, rec = out["result"], out["record"]
    assert res["correct"], res["checks"]
    assert set(out["linked"]) == {"r1.fq.gz"}
    assert len(out["linked"]) == 1 + res["attempted"]  # the warm job and the window's
    reads = 3000 * res["attempted"]
    assert rec["reads"] == res["run"]["reads"] == reads
    assert "pairs" not in rec and "pairs" not in res["run"]
    assert rec["bases"] == reads * 150
    assert rec["overlap_bytes"] == 0
    assert out["read"]["overlap_kernel_roofline"] is None
    assert out["read"]["overlap_kernel_roofline.cfdna"] is None
    assert out["read"]["throughput"] == rec["bases"] / 1e6 / rec["window_s"]


@pytest.mark.parametrize("cell,scans", [("pe_readme.lane", 1),
                                        ("pe_merge_corr.cfdna", 2)])
def test_accepted_cells_read_the_same_work(cell, scans, tmp_env, monkeypatch):
    """The parent's formulas: bases = pairs x 2 x 150, overlap bytes =
    pairs x scans x (2 x 150 + 21), the count reported as ``pairs``."""
    for k in ("FQTOOL_TPU_TORCH_DEVICE", "FQTOOL_TPU_TRACE", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(k, "")
    run.set_environment(False, "cpu")
    records = []
    real_reader = run.reader

    def reader(name):
        def read(rec):
            records.append(rec)
            return real_reader(name)(rec)
        return read
    monkeypatch.setattr(run, "reader", reader)
    res = run.run_cell(run.load_cell(cell, bench_json_with(cell, tmp_env)), SEED,
                       0.0, False, device="cpu", job_size=PAIRS)
    assert res["correct"], res["checks"]
    rec = records[0]
    pairs = PAIRS * res["attempted"]
    assert rec["pairs"] == res["run"]["pairs"] == pairs
    assert rec["bases"] == pairs * 2 * 150
    assert rec["overlap_bytes"] == pairs * scans * (2 * 150 + 21)
