"""Paired-end ``python -m fqtool_tpu_torch.main`` against ``fqtool_tpu.main``:
each paired-end stage flag.

Both CLIs run in-process on the same planted-overlap pairs (reads that run
past their insert read the TruSeq adapters) with the same argv: they must
return the same exit code and, on 0, write the same records to every output
stream and JSON reports equal under ``compare_json``.  The flag sets are
those a paired-end run once refused, each with the companion flags its
parser needs; the bare forms a parser rejects must be rejected alike.
``test_torch_pe_cli_configs.py`` runs the bench.py configurations, UMI,
split output, interleaved input and stdin.
"""

from __future__ import annotations

import pytest

from .test_torch_cli import _argv, _compare_outputs, _run_both
from .torch_pairs import ADAPTER_R1, ADAPTER_R2, write_pairs

FLAG_SETS = {
    "merge": ["-m", "--merge_output", "m.fq.gz"],
    "discard-unmerged": ["-m", "--merge_output", "m.fq.gz", "--discard_unmerged"],
    "discard-unmerged-alone": ["--discard_unmerged"],
    "correction": ["-c"],
    "adapter": ["-a"],
    "adapter-of-read1": ["-a", "--adapter_of_read1", ADAPTER_R1.decode()],
    "adapter-of-read2": ["-a", "--adapter_of_read2", ADAPTER_R2.decode()],
    "adapter-of-read1-alone": ["--adapter_of_read1", ADAPTER_R1.decode()],
    "detect-pe-adapter": ["--detect_pe_adapter"],
    "polyg": ["-g"],
    "polyx": ["-x"],
    "kmer": ["--kmer"],
    "dup": ["-d"],
    "umi": ["-u"],
    "split-number": ["-s"],
    "split-lines": ["-S"],
    "interleaved-with-I": ["--in_fq_interleaved"],
    "qu-bundled": ["-qu", "--umi_location", "1", "--umi_length", "8"],
    "qa-bundled": ["-qa"],
    "qd-bundled": ["-qd"],
    "qg-bundled": ["-qg"],
    "detect-pe-shortened": ["--detect_pe"],
}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_pe_flag_matches_jax(tmp_path, monkeypatch, name):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 600, seed=len(name),
                adapters=True)
    rcs = _run_both(tmp_path, _argv(tmp_path / "r1.fq", tmp_path / "r2.fq",
                                    *FLAG_SETS[name]), monkeypatch)
    assert rcs["torch"] == rcs["jax"], rcs
    if name.endswith(("-alone", "-with-I")):
        assert rcs["jax"] != 0  # the parser needs a companion flag
    if rcs["jax"] == 0:
        rep, _, n = _compare_outputs(tmp_path)
        assert n > 0
