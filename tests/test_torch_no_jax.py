"""fqtool_tpu_torch must run where JAX is not installed (the GPU hosts), and
on its own: it imports nothing of the JAX package ``fqtool_tpu``.

A subprocess installs an import hook that refuses ``jax``, ``jaxlib``,
``fqtool_tpu`` and ``fqtool_tpu.*`` (not ``fqtool_tpu_torch``), then runs the
port's CLI on a small paired or single-end input on the CPU (a paired-end
run with every stage among them, and a run split over three CPU devices
with the cross-pack overlap), imports ``chip_smoke``, ``cli_ab``
and ``overlap_ab`` (and with them everything the smoke run and the A/B
scripts use), and checks that none of them was loaded on the way; and runs
``python -m fqtool_tpu_torch.entry`` under the same hook.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from .torch_pairs import write_pairs
from .torch_reads import ADAPTER, write_reads

REPO = Path(__file__).resolve().parent.parent

# the import hook, also put in front of every rank of the multi-host tests
# (tests/torch_multihost.py)
NO_JAX_HOOK = r"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "fqtool_tpu")

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: fqtool_tpu_torch must import "
                              "neither JAX nor fqtool_tpu")

sys.meta_path.insert(0, NoJax())
"""

_SCRIPT = NO_JAX_HOOK + r"""
from fqtool_tpu_torch.main import main
rc = main(sys.argv[1:])
import chip_smoke
import cli_ab
import overlap_ab
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
sys.exit(rc)
"""


def _run_without_jax(tmp_path, argv, script=_SCRIPT, **env_extra):
    env = dict(os.environ, FQTOOL_TPU_TORCH_DEVICE="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.update(env_extra)
    proc = subprocess.run([sys.executable, "-c", script, *argv], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    if script is _SCRIPT:  # a CLI run writes its report
        assert (tmp_path / "report.json").exists()
    return proc


def test_port_cli_runs_without_jax(tmp_path):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 500, seed=3)
    _run_without_jax(tmp_path, [
        "-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq.gz", "-O", "o2.fq.gz",
        "-q", "-f", "3", "-t", "2", "--unpaired_read1", "up1.fq.gz",
        "--failed_out", "failed.fq.gz", "--ora"])
    assert (tmp_path / "o1.fq.gz").stat().st_size > 0


def test_port_single_end_runs_without_jax(tmp_path):
    write_reads(tmp_path / "r.fq", 1000, seed=3)
    _run_without_jax(tmp_path, [
        "-i", "r.fq", "-o", "o.fq.gz", "-g", "-x", "-a", "--adapter_of_read1",
        ADAPTER.decode(), "-d", "--kmer", "--kmer_length", "6", "-u",
        "--umi_location", "3", "--umi_length", "8"])
    assert (tmp_path / "o.fq.gz").stat().st_size > 0


def test_port_paired_end_all_stages_run_without_jax(tmp_path):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 500, seed=5, adapters=True)
    _run_without_jax(tmp_path, [
        "-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq.gz", "-O", "o2.fq.gz",
        "-m", "--merge_output", "m.fq.gz", "-c", "-a", "-g", "-x", "-d",
        "--kmer", "-u", "--umi_location", "6", "--umi_length", "8"])
    assert (tmp_path / "m.fq.gz").stat().st_size > 0


def test_port_sharded_overlapped_run_without_jax(tmp_path):
    write_pairs(tmp_path / "r1.fq", tmp_path / "r2.fq", 500, seed=6, adapters=True)
    proc = _run_without_jax(tmp_path, [
        "-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq.gz", "-O", "o2.fq.gz",
        "-m", "--merge_output", "m.fq.gz", "-c", "-d"],
        FQTOOL_TPU_TORCH_DEVICE="cpu,cpu,cpu", FQTOOL_TPU_PACK_OVERLAP="1")
    assert "data-parallel over 3 devices" in proc.stderr
    assert (tmp_path / "m.fq.gz").stat().st_size > 0


_ENTRY = NO_JAX_HOOK + r"""
import runpy
sys.argv = ["entry", "--devices", "cpu,cpu"]
try:
    runpy.run_module("fqtool_tpu_torch.entry", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
"""


def test_port_entry_module_runs_without_jax(tmp_path):
    proc = _run_without_jax(tmp_path, [], script=_ENTRY)
    assert "dryrun: SE+PE steps ran over 2 devices" in proc.stdout
