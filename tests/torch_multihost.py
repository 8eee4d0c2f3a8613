"""Helpers of the port's multi-host tests (``test_torch_multihost_*.py``).

Every port run here is a subprocess on the CPU (``FQTOOL_TPU_TORCH_DEVICE=cpu``,
one OpenMP thread) under the import hook of ``test_torch_no_jax.py``, so a
rank that loads ``jax``, ``jaxlib`` or ``fqtool_tpu`` fails.  A multi-host run
is N such processes on 127.0.0.1, formed into a group by
``FQTOOL_TPU_COORDINATOR`` / ``FQTOOL_TPU_NPROCS`` / ``FQTOOL_TPU_PROC_ID`` on
a free port; the single-process run of the same argv takes the same
environment without them.  ``CHUNK_ENV`` makes the packs small, so that a few
thousand records spread over every rank; ``FQTOOL_TPU_TRACE=1`` makes each
rank print its stage split at exit, whose dispatch count says how many packs
or chunks it ran (``dispatches``).
"""

from __future__ import annotations

import gzip
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

from .oracle import compare_json, diff_fastq, read_fastq
from .test_torch_no_jax import NO_JAX_HOOK

REPO = Path(__file__).resolve().parent.parent

# small packs: single-end packs of 256 reads, paired-end packs of 256 pairs
# in two chunks of 128; the write unit is then the whole pack in both modes
CHUNK_ENV = {
    "FQTOOL_TPU_SE_CHUNK": "256",
    "FQTOOL_TPU_SE_PACK_CHUNKS": "1",
    "FQTOOL_TPU_PE_CHUNK": "128",
    "FQTOOL_TPU_PE_PACK_CHUNKS": "2",
}

_RANK = NO_JAX_HOOK + r"""
from fqtool_tpu_torch.main import main
rc = main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
sys.exit(rc)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _env(extra=None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("FQTOOL_TPU_COORDINATOR", "FQTOOL_TPU_NPROCS",
                                "FQTOOL_TPU_PROC_ID", "FQTOOL_TPU_REDUCE_PORT"))}
    env.update(CHUNK_ENV)
    env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", FQTOOL_TPU_TORCH_DEVICE="cpu",
               FQTOOL_TPU_TRACE="1")
    env.update(extra or {})
    return env


def start(cmd, argv, workdir: Path, nprocs: int, extra_env=None,
          stdin=None) -> list:
    """Start ``cmd + argv`` as ``nprocs`` ranks of one group in ``workdir``
    (one plain process when ``nprocs`` is 1); returns the processes, for
    :func:`finish`."""
    workdir.mkdir(parents=True, exist_ok=True)
    group = {}
    if nprocs > 1:
        port = free_port()
        group = {"FQTOOL_TPU_COORDINATOR": f"127.0.0.1:{port}",
                 "FQTOOL_TPU_REDUCE_PORT": str(port),
                 "FQTOOL_TPU_NPROCS": str(nprocs)}
    procs = []
    try:
        for rank in range(nprocs):
            env = _env({**group, **(extra_env or {})})
            if nprocs > 1:
                env["FQTOOL_TPU_PROC_ID"] = str(rank)
            with open(stdin or os.devnull, "rb") as fin:
                procs.append(subprocess.Popen(
                    [*cmd, *map(str, argv)], cwd=workdir, env=env, stdin=fin,
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    except BaseException:
        finish(procs, 0)
        raise
    return procs


def finish(procs, timeout: float = 300) -> list:
    """Each rank's ``(returncode, stderr)``.  A rank that outlives
    ``timeout`` fails the test, and every rank is killed first."""
    try:
        out = []
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def start_port(argv, workdir: Path, nprocs: int = 1, **kw) -> list:
    """Start the port's CLI (``fqtool_tpu_torch.main``) as ``nprocs`` ranks."""
    return start([sys.executable, "-c", _RANK], argv, workdir, nprocs, **kw)


def run_port(argv, workdir: Path, nprocs: int = 1, timeout: float = 300, **kw) -> list:
    return finish(start_port(argv, workdir, nprocs, **kw), timeout)


def run_jax_ranks(argv, workdir: Path, nprocs: int) -> list:
    """``fqtool_tpu.main`` as ``nprocs`` ranks on the CPU, without
    ``jax.distributed`` (the TCP layer carries every byte between ranks)."""
    return finish(start([sys.executable, "-m", "fqtool_tpu.main"], argv, workdir, nprocs,
                        extra_env={"FQTOOL_TPU_PLATFORM": "cpu",
                                   "FQTOOL_TPU_NO_JAX_DIST": "1",
                                   "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}))


def assert_ok(results) -> None:
    fails = [f"rank {r} rc={rc}:\n{err[-3000:]}"
             for r, (rc, err) in enumerate(results) if rc != 0]
    assert not fails, "\n".join(fails)


# a row of the stage tree that FQTOOL_TPU_TRACE=1 prints at exit
# (host/tracing.py::dump): name, total, self and CPU seconds, calls
_DISPATCH = re.compile(
    r"^\s*(?:pe_|se_)dispatch\s+[\d.]+\s+[\d.]+\s+[\d.]+\s+(\d+)\s*$", re.M)


def dispatches(results) -> list:
    """Each rank's dispatch count (single-end packs, paired-end chunks) from
    its stage split."""
    return [sum(int(n) for n in _DISPATCH.findall(err)) for _, err in results]


def outputs(workdir: Path) -> list:
    """The FASTQ outputs of a run directory, by name."""
    return sorted(p.name for p in workdir.iterdir()
                  if p.name.endswith((".fq", ".fq.gz")))


def assert_same_bytes(single: Path, multi: Path) -> list:
    """Every output file of ``multi`` byte for byte equal to ``single``'s,
    no part file left behind, reports equal; returns the output names."""
    names = outputs(single)
    assert names and names == outputs(multi), (names, outputs(multi))
    assert not list(multi.glob("*.part")), list(multi.glob("*.part"))
    for name in names:
        assert (single / name).read_bytes() == (multi / name).read_bytes(), \
            f"{name}: the multi-host bytes differ from the single-process run"
    assert_same_report(single, multi)
    return names


def assert_same_report(ours: Path, ref: Path) -> dict:
    with open(ours / "report.json") as f:
        a = json.load(f)
    with open(ref / "report.json") as f:
        b = json.load(f)
    diffs = compare_json(a, b)
    assert not diffs, "\n".join(diffs[:40])
    return a


def assert_same_records(ours: Path, ref: Path) -> int:
    """Every output of ``ours`` holds the records of ``ref``'s file of the
    same name, and the reports agree; returns the record count."""
    names = outputs(ref)
    assert names == outputs(ours), (outputs(ours), names)
    n = 0
    for name in names:
        a = read_fastq(ours / name)
        d = diff_fastq(a, read_fastq(ref / name))
        assert not d, f"{name}: " + "\n".join(d)
        n += len(a)
    assert_same_report(ours, ref)
    return n


def compare_runs(tmp_path: Path, argv, nprocs: int, refs: dict) -> tuple:
    """Run ``argv`` as ``nprocs`` ranks and hold the run (a) byte for byte
    against the port's single-process run and (b) record for record against
    ``fqtool_tpu.main`` in this process; both references run once per argv
    (cached in ``refs``), while the ranks run.  Every rank must have run a
    pack.  Returns (output names, record count)."""
    multi = tmp_path / f"mh{nprocs}"
    key = tuple(map(str, argv))
    pending = [start_port(argv, multi, nprocs)]
    if key not in refs:
        base = tmp_path / "ref"
        pending.append(start_port(argv, base / "single"))
        try:
            run_jax_in_process(argv, base / "jax")
        finally:
            results = [finish(p) for p in pending]
        assert_ok(results[1])
        refs[key] = base
    else:
        results = [finish(p) for p in pending]
    assert_ok(results[0])
    assert all(dispatches(results[0])), \
        f"a rank ran no pack: {dispatches(results[0])}"
    names = assert_same_bytes(refs[key] / "single", multi)
    return names, assert_same_records(multi, refs[key] / "jax")


def run_jax_in_process(argv, workdir: Path) -> None:
    """``fqtool_tpu.main`` in this process (a single-process run)."""
    from fqtool_tpu.main import main
    workdir.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        assert main([str(a) for a in argv]) == 0
    finally:
        os.chdir(cwd)


def plant_repeats(src: Path, dst: Path, every: int = 5, distinct: int = 3) -> Path:
    """``src`` with the sequence and quality of every ``every``-th record
    replaced by those of one of its first ``distinct`` records, so that the
    ORA pre-pass finds overrepresented sequences; applied to both mates of a
    pair with the same arguments, the repeated pairs stay pairs."""
    lines = src.read_bytes().splitlines(keepends=True)
    for i in range(0, len(lines) // 4, every):
        j = (i // every) % distinct
        lines[4 * i + 1] = lines[4 * j + 1]
        lines[4 * i + 3] = lines[4 * j + 3]
    dst.write_bytes(b"".join(lines))
    return dst


def plant_mirrored_duplicates(src: Path, dst: Path, prefix: int = 64) -> Path:
    """``src`` with record ``n-1-i`` (of ``n``) starting with the first
    ``prefix`` bases and qualities of record ``i``, for every ``i < n/2``: the
    two share their duplication key and k-mer but not their GC, so the
    duplication report depends on which of them the stream holds first.  A
    rank that numbers its records from 0 instead of their global index puts
    the later copy first, for every ``i`` past about ``n/2/world``.  Applied
    to both mates with the same arguments, the pairs stay pairs."""
    lines = src.read_bytes().splitlines(keepends=True)
    n = len(lines) // 4
    for i in range(n // 2):
        j = n - 1 - i
        for k in (1, 3):
            lines[4 * j + k] = lines[4 * i + k][:prefix] + lines[4 * j + k][prefix:]
    dst.write_bytes(b"".join(lines))
    return dst


def gzip_members(src: Path, dst: Path, members: int) -> Path:
    """``src`` (plain FASTQ) gzipped as ``members`` concatenated gzip members
    split at record boundaries, so that the multi-host ingest planner can
    give each rank its own member range."""
    lines = src.read_bytes().splitlines(keepends=True)
    recs = len(lines) // 4
    with open(dst, "wb") as f:
        for k in range(members):
            lo, hi = recs * k // members, recs * (k + 1) // members
            f.write(gzip.compress(b"".join(lines[4 * lo : 4 * hi]), 6))
    return dst
