"""The port's copy of ``config/`` parses every argv as ``fqtool_tpu.config``.

Each argv goes through ``config.cli.parse_args`` of both packages (input
files made in a temporary directory): the parsed ``Options`` must be equal
under ``dataclasses.asdict``, and ``kernel_params`` equal field by field for
both mates.  An argv that one side refuses must be refused by the other with
the same ``OptionError`` text, or the same argparse exit and message.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest

from fqtool_tpu.config import cli as jcli
from fqtool_tpu.config import options as joptions
from fqtool_tpu_torch.config import cli as tcli
from fqtool_tpu_torch.config import options as toptions

from .test_torch_cli import _argv
from .test_torch_pe_cli import FLAG_SETS as PE_FLAG_SETS
from .test_torch_pe_cli_configs import CASES as PE_CLI_CASES
from .test_torch_pe_cli_configs import INTERLEAVED
from .test_torch_se_cli import CASES as SE_CLI_CASES
from .torch_reads import ADAPTER

REPO = Path(__file__).resolve().parent.parent
AD = ADAPTER.decode()
SE = ["-i", "r.fq", "-o", "out.fq.gz"]
PE = ["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq.gz", "-O", "o2.fq.gz"]


def _bench_configs():
    """(name, argv) of bench.py's CONFIGS, read from its source (importing
    bench.py would set FQTOOL_TPU_TRACE in this process)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                [t.id for t in node.targets if isinstance(t, ast.Name)] == ["CONFIGS"]:
            return [(name, (PE if paired else SE) + list(argv))
                    for name, _, _, paired, _, argv in ast.literal_eval(node.value)]
    raise AssertionError("bench.py has no CONFIGS")


ARGVS = {
    # the port's paired-end CLI tests (tests/test_torch_cli.py)
    "cli-qualtrim": _argv("r1.fq", "r2.fq", "-q", "-f", "3", "-t", "2"),
    "cli-random-shapes": _argv("r1.fq", "r2.fq", "-q", "--enable_cut_front",
                               "--enable_cut_tail", "-l", "--max_length", "140",
                               "-y", "-F", "2"),
    "cli-single-end": SE + ["-q", "-g", "-a", "--adapter_of_read1", AD,
                            "--failed_out", "failed.fq.gz"],
    "cli-stdin": _argv("/dev/stdin", "r2.fq", "-q"),
    "no-jax-pe": PE + ["-q", "-f", "3", "-t", "2", "--unpaired_read1", "up1.fq.gz",
                       "--failed_out", "failed.fq.gz", "--ora"],
    "no-jax-se": SE + ["-g", "-x", "-a", "--adapter_of_read1", AD, "-d", "--kmer",
                       "--kmer_length", "6", "-u", "--umi_location", "3",
                       "--umi_length", "8"],
    "se-cli-stdin": ["-i", "/dev/stdin", "-o", "out.fq.gz", "-q", "-g", "--ora"],
    # tests/test_golden_random.py
    "random-se-trims-filters": SE + ["-q", "-f", "2", "-t", "1", "-l", "-y", "-g",
                                     "-x", "--failed_out", "failed.fq.gz"],
    "random-se-cuts-adapter": SE + ["-q", "--enable_cut_front", "--enable_cut_tail",
                                    "-a", "--adapter_of_read1", AD],
    "random-se-cut-right-dup": SE + ["-q", "--enable_cut_right", "-d"],
    "random-pe-all": PE + ["-q", "-a", "-c", "-g", "--unpaired_read1", "up1.fq.gz",
                           "--unpaired_read2", "up2.fq.gz",
                           "--failed_out", "failed.fq.gz"],
    "random-pe-merge": PE + ["-m", "--merge_output", "merged.fq.gz", "-c", "-x"],
    # refused or invalid: OptionError from update/validate, argparse errors
    "merge-without-output": PE + ["-m"],
    "polyx-bad-base": SE + ["-x", "--base_to_trim", "ACGU"],
    "umi-read1-no-length": SE + ["-u", "--umi_location", "3"],
    "split-both": SE + ["-s", "-S", "--splie_file_line", "400"],
    "adapter-seq-without-a": SE + ["--adapter_of_read1", AD],
    "merge-without-r2": SE + ["-m", "--merge_output", "m.fq.gz"],
    "quality-limit-200": SE + ["-q", "-e", "200"],
    "missing-input": ["-i", "absent.fq", "-o", "o.fq.gz"],
}
ARGVS.update({f"bench-{name}": argv for name, argv in _bench_configs()})
ARGVS.update({f"se-cli-{name}": SE + flags for name, flags in SE_CLI_CASES.items()})
ARGVS.update({f"pe-cli-{name}": _argv("r1.fq", "r2.fq", *flags)
              for name, flags in {**PE_FLAG_SETS, **PE_CLI_CASES}.items()})
ARGVS.update({f"pe-cli-interleaved-{name}": [
    "-i", "inter.fq", "--in_fq_interleaved", "-o", "o1.fq.gz", *flags]
    for name, flags in INTERLEAVED.items()})


def _parse(cli, argv, capsys):
    """("ok", Options) | ("OptionError", text) | ("exit", code, stderr)."""
    try:
        return ("ok", cli.parse_args(list(argv)))
    except (joptions.OptionError, toptions.OptionError) as e:
        return ("OptionError", type(e).__name__, str(e))
    except SystemExit as e:
        return ("exit", e.code, capsys.readouterr().err)


def test_argv_sets_cover_the_bench_configs():
    names = [n for n, _ in _bench_configs()]
    assert names == ["se_qualtrim", "se_polygx", "se_adapter", "pe_merge_corr",
                     "pe_full"]


@pytest.mark.parametrize("name", list(ARGVS))
def test_config_parity(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    for f in ("r.fq", "r1.fq", "r2.fq"):
        (tmp_path / f).write_bytes(b"@r\nACGT\n+\nIIII\n")
    argv = ARGVS[name]
    ref = _parse(jcli, argv, capsys)
    got = _parse(tcli, argv, capsys)
    assert got[0] == ref[0], (got, ref)
    if ref[0] != "ok":
        assert got == ref
        return
    jopt, topt = ref[1], got[1]
    assert type(topt).__module__ == "fqtool_tpu_torch.config.options"
    assert dataclasses.asdict(topt) == dataclasses.asdict(jopt)
    for is_r2 in (False, True):
        jp, tp = jopt.kernel_params(is_r2=is_r2), topt.kernel_params(is_r2=is_r2)
        jf, tf = dataclasses.fields(jp), dataclasses.fields(tp)
        assert [f.name for f in tf] == [f.name for f in jf]
        for f in jf:
            assert getattr(tp, f.name) == getattr(jp, f.name), (is_r2, f.name)
