"""Multi-device data parallelism of fqtool_tpu_torch (``dist/sharding.py``)
against the port's single-device run and ``fqtool_tpu.dist.sharding``.

The device lists repeat the CPU (``["cpu"] * k``, k = 2, 3, 8); row counts
include ones that k does not divide and ones below k.  The JAX side runs on
its 8-device CPU mesh (tests/conftest.py), which pads the rows to a multiple
of 8; its per-row outputs are cut back to the chunk's rows.  Two cases are
shape traps for a join that goes by shape: a paired-end chunk of 64 pairs
with ``-c`` and 3-mers (64 rows = ``4**3`` k-mer bins = the 64 cells of
``correction_matrix``) and a single-end chunk of 8 rows (= the 8 base bins of
every ``BatchStats`` plane).  Then the CLI with
``FQTOOL_TPU_TORCH_DEVICE=cpu,cpu,cpu`` against ``fqtool_tpu.main`` (records
and reports; under conftest its run shards over 8 devices) and byte for byte
against the port's one-device run, one of them as 2 ranks of 2 devices each.
"""

from __future__ import annotations

import numpy as np
import pytest

from fqtool_tpu.config import cli as jcli
from fqtool_tpu_torch.dist import sharding
from fqtool_tpu_torch.pipeline.pe import pe_pipeline_call
from fqtool_tpu_torch.pipeline.se import se_pipeline_call

from . import test_torch_pe_pipeline as pe_case
from . import test_torch_se_pipeline as se_case
from .test_torch_cli import _compare_outputs, _run
from .test_torch_pe_pipeline import assert_same_outputs
from .torch_multihost import (assert_ok, assert_same_bytes, assert_same_records,
                              dispatches, finish, run_jax_in_process, start_port)
from .torch_pairs import (ADAPTER_R1, ADAPTER_R2, _options, kernel_params_se,
                          write_pairs)
from .torch_reads import ADAPTER, write_reads

PE = ["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq", "-O", "o2.fq"]
# every stage that adds an output kind: k-mer histograms (3-mers, set below),
# duplication keys (key_hi None at 12 bases, set at 17), correction, merge
PE_FLAGS = ["-q", "-c", "-m", "--merge_output", "m.fq", "-d", "-a",
            "--adapter_of_read1", ADAPTER_R1.decode(), "--adapter_of_read2",
            ADAPTER_R2.decode(), "--kmer", "-g", "-x"]
SE_FLAGS = ["-q", "-g", "-x", "-a", "--adapter_of_read1", ADAPTER.decode(), "-d",
            "--dup_ana_key_len", "17", "--kmer", "--kmer_length", "4"]
# the reductions of the JAX pipelines' outputs; everything else is per row
JAX_REDUCED = {"pre", "post", "pre1", "pre2", "post1", "post2", "postM",
               "pre_kmer", "post_kmer", "pre1_kmer", "pre2_kmer", "post1_kmer",
               "post2_kmer", "postM_kmer", "correction_matrix"}


def _pe_args(flags, cli=None, kmer=3):
    opt = _options(PE + flags, cli)
    opt.kmer.kmer_len = kmer  # below the CLI's range of 4-16
    return (opt.kernel_params(is_r2=False), opt.kernel_params(is_r2=True),
            dict(adapter_r1=ADAPTER_R1, adapter_r2=ADAPTER_R2, with_kmer=True,
                 use_start0=True))


def _jax_rows(out: dict, rows: int) -> dict:
    """A JAX sharded output with its per-row arrays cut to ``rows``."""
    import jax
    out = jax.device_get(out)
    cut = {}
    for key, v in out.items():
        if key in JAX_REDUCED:
            cut[key] = v
        elif isinstance(v, tuple):
            cut[key] = type(v)(*(None if f is None else np.asarray(f)[:rows]
                                 for f in v))
        else:
            cut[key] = np.asarray(v)[:rows]
    return cut


_JAX = {}  # (mode, rows) -> JAX's sharded output, shared by the k cases


def _pe_chunk(rows):
    """test_torch_pe_pipeline's planes, cut to ``rows`` (it makes 8 or more)."""
    planes, start1, start2, keep = pe_case.chunk(rows, max(rows, 8))
    return [a[:rows] for a in planes], start1[:rows], start2[:rows], keep[:rows]


def _jax_se(rows):
    if ("se", rows) not in _JAX:
        from fqtool_tpu.dist.sharding import make_mesh, run_se_sharded
        seq, qual, lens, keep = se_case.chunk(rows, rows)
        start0 = np.minimum(np.arange(rows) % 5, lens).astype(np.int32)
        p = kernel_params_se(*SE_FLAGS, cli=jcli)
        mesh = make_mesh(8)
        with mesh:
            out = run_se_sharded(mesh, seq, qual, lens, start0, keep, p,
                                 adapter_r1=ADAPTER, use_start0=True, with_kmer=True)
        _JAX["se", rows] = _jax_rows(out, rows)
    return _JAX["se", rows]


def _jax_pe(rows):
    if ("pe", rows) not in _JAX:
        from fqtool_tpu.dist.sharding import make_mesh, run_pe_sharded
        planes, start1, start2, keep = _pe_chunk(rows)
        p, p2, kw = _pe_args(PE_FLAGS, jcli)
        mesh = make_mesh(8)
        with mesh:
            out = run_pe_sharded(mesh, *planes, start1, start2, keep,
                                 np.ones(rows, bool), p, p2, **kw)
        _JAX["pe", rows] = _jax_rows(out, rows)
    return _JAX["pe", rows]


@pytest.mark.parametrize("k,rows", [(2, 37), (3, 8), (8, 5), (8, 8)])
def test_se_sharded_equals_one_device_and_jax(k, rows):
    seq, qual, lens, keep = se_case.chunk(rows, rows)
    start0 = np.minimum(np.arange(rows) % 5, lens).astype(np.int32)
    p = kernel_params_se(*SE_FLAGS)
    kw = dict(adapter_r1=ADAPTER, use_start0=True, with_kmer=True)
    got = sharding.run_se_sharded(["cpu"] * k, seq, qual, lens, start0, keep, p, **kw)
    single = se_pipeline_call((seq, qual, lens, start0, keep), "cpu", p, **kw).get()
    assert_same_outputs(single, got)
    assert got["dup"].key_hi is not None and got["pre"].cycle_q20.shape[0] == 8
    assert_same_outputs(_jax_se(rows), got)


@pytest.mark.parametrize("k,rows", [(2, 64), (3, 64), (8, 64), (3, 37), (8, 3)])
def test_pe_sharded_equals_one_device_and_jax(k, rows):
    planes, start1, start2, keep = _pe_chunk(rows)
    p, p2, kw = _pe_args(PE_FLAGS)
    got = sharding.run_pe_sharded(["cpu"] * k, *planes, start1, start2, keep,
                                  p, p2, **kw)
    single = pe_pipeline_call(planes + [start1, start2, keep], "cpu", p, p2,
                              **kw).get()
    assert_same_outputs(single, got)
    assert got["dup"].key_hi is None and got["pre1_kmer"].shape == (4 ** 3,)
    assert got["correction_matrix"].shape == (64,)
    if rows == 64:
        assert got["correction_matrix"].sum() > 0 and got["postM"].reads > 0
    if rows in (64, 3):
        assert_same_outputs(_jax_pe(rows), got)


def test_row_bounds_are_tensor_split_sizes():
    import torch
    for rows in (0, 1, 5, 8, 37, 64):
        for k in (1, 2, 3, 8):
            want = [len(t) for t in torch.tensor_split(torch.arange(rows), k)]
            assert [hi - lo for lo, hi in sharding.row_bounds(rows, k)] == want


def test_join_is_by_key_not_by_shape(monkeypatch):
    """A per-row output whose key is missing from REDUCED fails the join
    loudly instead of being summed or concatenated by its shape."""
    parts = [{"x": np.zeros(4, np.int32)}, {"x": np.zeros(4, np.int32)}]
    with pytest.raises(ValueError, match="not in REDUCED"):
        sharding.join_outputs(parts, [2, 2])
    monkeypatch.setattr(sharding, "REDUCED", sharding.REDUCED | {"x"})
    assert sharding.join_outputs(parts, [2, 2])["x"].dtype == np.int32


# the CLI over three CPU devices: name -> (paired, flags)
CLI_CASES = {
    "se_qualtrim": (False, ["-q", "-f", "3", "-t", "2", "--failed_out",
                            "failed.fq.gz"]),
    "pe_merge_corr": (True, ["-m", "--merge_output", "merged.fq.gz", "-c",
                             "--unpaired_read1", "up1.fq.gz", "--unpaired_read2",
                             "up2.fq.gz", "--failed_out", "failed.fq.gz"]),
    "pe_full": (True, ["-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                       "--detect_pe_adapter"]),
    # tests/test_sharded_e2e.py::test_se_sharded_umi_dup on in-repo reads
    "se_umi_dup": (False, ["-q", "-d", "-u", "--umi_location", "3",
                           "--umi_length", "6"]),
}


def _cli_argv(tmp_path, paired, flags):
    if paired:
        write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 300, seed=21,
                    adapters=True)
        return ["-i", str(tmp_path / "r1.fq"), "-I", str(tmp_path / "r2.fq"),
                "-o", "o1.fq.gz", "-O", "o2.fq.gz", *flags]
    write_reads(tmp_path / "r.fq", 500, seed=22)
    return ["-i", str(tmp_path / "r.fq"), "-o", "o1.fq.gz", *flags]


@pytest.mark.parametrize("name", list(CLI_CASES) + ["pe_full_2_ranks"])
def test_cli_over_three_devices(tmp_path, monkeypatch, capfd, name):
    from fqtool_tpu.main import main as jax_main
    from fqtool_tpu_torch.main import main as torch_main

    paired, flags = CLI_CASES[name.replace("_2_ranks", "")]
    argv = _cli_argv(tmp_path, paired, flags)
    if name.endswith("_2_ranks"):
        # 2 ranks with 2 CPU devices each, against the port's one-device
        # single-process run (bytes) and fqtool_tpu.main (records, reports)
        pending = [start_port(argv, tmp_path / "mh", 2,
                              extra_env={"FQTOOL_TPU_TORCH_DEVICE": "cpu,cpu"}),
                   start_port(argv, tmp_path / "one")]
        try:
            run_jax_in_process(argv, tmp_path / "jax")
        finally:
            ranks, one = [finish(p) for p in pending]
        assert_ok(one)
        assert_ok(ranks)
        assert all(dispatches(ranks))
        assert all("data-parallel over 2 devices" in err for _, err in ranks)
        assert_same_bytes(tmp_path / "one", tmp_path / "mh")
        assert assert_same_records(tmp_path / "mh", tmp_path / "jax") > 0
        return
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu,cpu,cpu")
    assert _run(torch_main, argv, tmp_path / "torch") == 0
    assert "data-parallel over 3 devices" in capfd.readouterr().err
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu")
    assert _run(torch_main, argv, tmp_path / "one") == 0
    assert _run(jax_main, argv, tmp_path / "jax") == 0
    assert_same_bytes(tmp_path / "one", tmp_path / "torch")
    _, _, n = _compare_outputs(tmp_path)
    assert n > 0


def test_shard_off_runs_on_the_first_device(tmp_path, monkeypatch, capfd):
    from fqtool_tpu_torch.main import main as torch_main
    argv = _cli_argv(tmp_path, False, CLI_CASES["se_qualtrim"][1])
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu,cpu")
    monkeypatch.setenv("FQTOOL_TPU_SHARD", "0")
    assert _run(torch_main, argv, tmp_path / "torch") == 0
    assert "data-parallel" not in capfd.readouterr().err
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu")
    assert _run(torch_main, argv, tmp_path / "one") == 0
    assert_same_bytes(tmp_path / "one", tmp_path / "torch")


@pytest.mark.parametrize("value,want", [
    ("cpu", ["cpu"]), ("cpu,cpu,cpu", ["cpu"] * 3), (" cpu , cpu ", ["cpu"] * 2)])
def test_device_list_grammar(monkeypatch, value, want):
    from fqtool_tpu_torch.main import device_from_env
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", value)
    assert [str(d) for d in device_from_env()] == want


@pytest.mark.parametrize("value", ["cuda", "cuda:0,cuda:0", "cpu,cuda:1", "gpu", ""])
def test_device_list_errors(monkeypatch, value):
    import torch

    from fqtool_tpu_torch.config.options import OptionError
    from fqtool_tpu_torch.main import device_from_env
    if torch.cuda.is_available():
        pytest.skip("this check is for hosts without a CUDA device")
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", value)
    with pytest.raises(OptionError, match="FQTOOL_TPU_TORCH_DEVICE"):
        device_from_env()
