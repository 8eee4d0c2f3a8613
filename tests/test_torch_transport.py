"""The upload path of fqtool_tpu_torch, and its CLI under the transport
switches of fqtool_tpu.

- the CLI under ``FQTOOL_TPU_PACKED=1`` with ``FQTOOL_TPU_PACKED5`` 1 and 0,
  and under ``FQTOOL_TPU_INBLOB=1``, which the port does not read: every
  chunk still crosses through the arena, and the output is byte for byte
  the port's default run and record for record, report for report
  ``fqtool_tpu.main`` under the same variable (on one device, where its
  input blob is not overridden by a mesh).  The inputs have binned
  qualities (six values), so the JAX package's 5-bit transport takes every
  pack.  ``FQTOOL_TPU_PACK_OVERLAP=1`` and ``FQTOOL_TPU_HEADCACHE=0`` the
  same way, with packs of 128-256 records, so the cross-pack overlap has
  packs to overlap, and ``--ora`` with ``FQTOOL_TPU_HEADCACHE=0``, so the
  head cache is on in its default run;
- the CLI on the argv of each benchmark cell's configuration, on one CPU
  device and split over three, against ``fqtool_tpu.main``;
- ``FQTOOL_TPU_PROFILE_DIR`` writing a trace of a CPU run;
- ``pipeline/device.py``'s arena (``pack``/``upload``): the layout, the
  typed views of every plane set the runners dispatch against
  ``host_planes``, one upload a part in ``dispatch_on``, the ``staged``
  counter, ``se_pipeline_call``/``pe_pipeline_call`` equal to the pipelines
  fed one copy a plane, and the kernels' load widths on the arena's views
  equal to those on planes allocated one by one.  The cases marked ``card``
  skip where torch sees no CUDA card; on a card the arena is page-locked on
  every upload.  JAX is imported inside the tests that compare with it, so
  on the card this file runs as

    python -m pytest -p no:cacheprovider --noconftest -m card tests/test_torch_transport.py
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from fqtool_tpu_torch.dist.sharding import dispatch_on, row_bounds
from fqtool_tpu_torch.entry import assert_same_outputs as same_outputs
from fqtool_tpu_torch.ops import stats_cuda
from fqtool_tpu_torch.ops.kernel_lib import vector_width
from fqtool_tpu_torch.pipeline import device, pe_runner, runner
from fqtool_tpu_torch.pipeline.device import dispatch, host_planes, outputs_to_numpy
from fqtool_tpu_torch.pipeline.pe import pe_pipeline, pe_pipeline_call
from fqtool_tpu_torch.pipeline.pe_runner import pipeline_args
from fqtool_tpu_torch.pipeline.se import se_pipeline, se_pipeline_call

from .test_torch_cli import _compare_outputs, _run
from .torch_multihost import assert_same_bytes
from .torch_pairs import (ADAPTER_R1, _options, fastq_bytes, kernel_params_se,
                          make_pairs, write_pairs)
from .torch_reads import ADAPTER, bin_qualities, make_reads, write_reads


@pytest.fixture
def dispatched(monkeypatch):
    """The rows of each chunk that the runners hand to ``dispatch_on``, one
    entry a chunk, from the moment the fixture is set up."""
    rows = []

    def counted(devices, body, arrays, **kw):
        rows.append(len(arrays[0]))
        return dispatch_on(devices, body, arrays, **kw)

    monkeypatch.setattr(runner, "dispatch_on", counted)
    monkeypatch.setattr(pe_runner, "dispatch_on", counted)
    return rows


def _parts(rows: int, devices: int) -> int:
    """Parts ``dispatch_on`` uploads for a chunk of ``rows`` rows: one a
    device with rows, and one for a chunk of none."""
    return max(1, min(rows, devices))


# --- the CLI under each transport switch -----------------------------------
VARIANTS = {
    "packed5": {"FQTOOL_TPU_PACKED": "1", "FQTOOL_TPU_PACKED5": "1"},
    "packed8": {"FQTOOL_TPU_PACKED": "1", "FQTOOL_TPU_PACKED5": "0"},
    "inblob": {"FQTOOL_TPU_INBLOB": "1"},
    "pack_overlap": {"FQTOOL_TPU_PACK_OVERLAP": "1"},
    "headcache_off": {"FQTOOL_TPU_HEADCACHE": "0"},
}
# packs of 128-256 records (single-end: 2 x 128-row chunks, set below);
# --ora, whose pre-pass reads a head, only where the head cache is switched
ARGV = {
    "se": ["-o", "o1.fq.gz", "-q", "-g", "--failed_out", "failed.fq.gz"],
    "pe": ["-o", "o1.fq.gz", "-O", "o2.fq.gz", "-q", "-c",
           "--max_item_in_pack", "128", "--unpaired_read1", "up1.fq.gz",
           "--failed_out", "failed.fq.gz"],
}


def _jax_calls():
    from fqtool_tpu.pipeline import pe as jpe
    from fqtool_tpu.pipeline import se as jse
    return (jse.se_pipeline_call, jse.se_packed_call, jse.se_packed5_call,
            jpe.pe_pipeline_call, jpe.pe_packed_call, jpe.pe_packed5_call)


@pytest.mark.parametrize("mode", ["se", "pe"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cli_transport_switch(tmp_path, monkeypatch, capfd, dispatched, variant,
                              mode):
    from fqtool_tpu.main import main as jax_main
    from fqtool_tpu_torch.main import main as torch_main

    if mode == "se":
        write_reads(tmp_path / "raw.fq", 600, seed=31)
        argv = ["-i", str(bin_qualities(tmp_path / "raw.fq", tmp_path / "r.fq"))]
    else:
        write_pairs(tmp_path / "raw1.fq", tmp_path / "raw2.fq", 350, seed=32,
                    adapters=True)
        argv = ["-i", str(bin_qualities(tmp_path / "raw1.fq", tmp_path / "r1.fq")),
                "-I", str(bin_qualities(tmp_path / "raw2.fq", tmp_path / "r2.fq"))]
    argv += ARGV[mode] + (["--ora"] if variant == "headcache_off" else [])
    monkeypatch.setattr(runner, "SE_CHUNK", 128)
    # fqtool_tpu on one device: on a mesh it keeps its per-array transport
    # whatever FQTOOL_TPU_INBLOB says (fqtool_tpu/pipeline/blob.py:254)
    monkeypatch.setenv("FQTOOL_TPU_SHARD", "0")
    for call in _jax_calls():
        monkeypatch.setattr(call, "_mesh", None)
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu")
    assert _run(torch_main, argv, tmp_path / "default") == 0
    dispatched.clear()
    device.staged.clear()
    for k, v in VARIANTS[variant].items():
        monkeypatch.setenv(k, v)
    capfd.readouterr()
    assert _run(torch_main, argv, tmp_path / "torch") == 0
    # every chunk through the arena, whatever the variable says
    staged = dict(device.staged)
    assert len(dispatched) >= 3 and staged["chunks"] == len(dispatched), staged
    assert staged["pinned"] == 0
    assert _run(jax_main, argv, tmp_path / "jax") == 0
    assert_same_bytes(tmp_path / "default", tmp_path / "torch")
    _, _, n = _compare_outputs(tmp_path)
    assert n > 0


# the argv of each benchmark cell's configuration (benchmark/configs/<name>.json),
# with the paths of its outputs and reports relative to the run's directory
CELL_ARGV = {
    "pe_readme": ["-o", "out1.fq.gz", "-O", "out2.fq.gz",
                  "-q", "--kmer", "--kmer_length", "6", "-d", "-a",
                  "--detect_pe_adapter", "-J", "report.json", "-H", "report.html"],
    "pe_merge_corr": ["-o", "out1.fq.gz", "-O", "out2.fq.gz",
                      "-q", "-m", "--merge_output", "merged.fq.gz", "-c",
                      "--unpaired_read1", "up1.fq.gz", "--unpaired_read2",
                      "up2.fq.gz", "--failed_out", "failed.fq.gz",
                      "-J", "report.json", "-H", "report.html"],
    "se_fastp_default": ["-o", "out1.fq.gz",
                         "-q", "-Q", "15", "-U", "0.4", "-N", "5", "-l",
                         "--min_length", "15", "-a", "--adapter_of_read1",
                         ADAPTER.decode(), "-g", "-d",
                         "-J", "report.json", "-H", "report.html"],
}
_JAX_CELL = {}  # config -> (its input argv, fqtool_tpu.main's output dir)


def _write_cell_inputs(d, paired: bool) -> list:
    """Inputs for a cell's argv in ``d``, as ``-i``/``-I`` argv: 300 pairs of
    150 bases that read the TruSeq adapters past the insert, or 400 single
    reads of 151 bases that read the adapter of read 1 and then G past the
    fragment (at the cell's 75 bases few of a few hundred reads would reach
    it).  In each mate 20 reads are of low quality, 20 hold six N and 20 go
    dark (G) from cycle 8, so that every filter of the argv has reads to
    fail; qualities binned by ``bin_qualities``."""
    rng = np.random.default_rng(43)
    if paired:
        s1, q1, s2, q2, _ = make_pairs(300, 41, 150, adapters=True)
        mates = [(s1, q1), (s2, q2)]
    else:
        s, q, _ = make_reads(400, 42)
        mates = [(s, q)]
    argv = []
    for mate, (s, q) in enumerate(mates, 1):
        rows = rng.permutation(len(s))[:60]
        q[rows[:20], :100] = 33 + 2
        s[rows[20:40], 10:16] = ord("N")
        q[rows[20:40], 10:16] = 33 + 2
        s[rows[40:], 8:] = ord("G")
        (d / f"raw{mate}.fq").write_bytes(fastq_bytes(s, q, mate, 0))
        argv += ["-i" if mate == 1 else "-I",
                 str(bin_qualities(d / f"raw{mate}.fq", d / f"r{mate}.fq"))]
    return argv


def _cell_run(name: str, tmp_path_factory) -> tuple:
    """The inputs of ``name`` and ``fqtool_tpu.main``'s run on them, made
    once for both device lists."""
    if name not in _JAX_CELL:
        from fqtool_tpu.main import main as jax_main

        d = tmp_path_factory.mktemp(name)
        inputs = _write_cell_inputs(d, name.startswith("pe_"))
        assert _run(jax_main, inputs + CELL_ARGV[name], d / "jax") == 0
        _JAX_CELL[name] = inputs, d / "jax"
    return _JAX_CELL[name]


@pytest.mark.parametrize("devices", ["cpu", "cpu,cpu,cpu"])
@pytest.mark.parametrize("name", list(CELL_ARGV))
def test_cli_cell_argv_matches_jax(tmp_path, tmp_path_factory, monkeypatch,
                                   dispatched, name, devices):
    """The port on a cell's argv equals ``fqtool_tpu.main`` record for
    record and report for report, on one CPU device and split over three,
    with one upload a part of every chunk; chunks of 128 rows, so a run
    dispatches several."""
    from fqtool_tpu_torch.main import main as torch_main

    inputs, jax_dir = _cell_run(name, tmp_path_factory)
    shutil.copytree(jax_dir, tmp_path / "jax")
    monkeypatch.setattr(runner, "SE_CHUNK", 128)
    monkeypatch.setattr(pe_runner, "PE_CHUNK", 128)
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", devices)
    device.staged.clear()
    assert _run(torch_main, inputs + CELL_ARGV[name], tmp_path / "torch") == 0
    k = len(devices.split(","))
    assert len(dispatched) >= 3
    assert device.staged["chunks"] == sum(_parts(n, k) for n in dispatched)
    rep, outputs, n = _compare_outputs(tmp_path)
    assert n > 0 and len(outputs) == len([a for a in CELL_ARGV[name]
                                           if a.endswith(".fq.gz")])
    failed = rep["FilterResult"]
    assert failed["LowQualityReads"] > 0 and failed["TooManyNReads"] > 0, failed
    assert failed.get("TooShortReads", 1) > 0, failed
    if "-a" in CELL_ARGV[name]:
        assert rep["AdapterTrim"]["AdapterTrimmedReads"] > 0


def test_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    from fqtool_tpu_torch.main import main as torch_main

    write_reads(tmp_path / "r.fq", 500, seed=33)
    monkeypatch.setenv("FQTOOL_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FQTOOL_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    argv = ["-i", str(tmp_path / "r.fq"), "-o", "o.fq.gz", "-q", "-g"]
    assert _run(torch_main, argv, tmp_path / "torch") == 0
    traces = list((tmp_path / "prof").glob("fqtool_tpu_torch.*.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


# --- pipeline/device.py's arena ---------------------------------------------
def _on(dev: str) -> torch.device:
    """``dev`` as a torch device; a card skips unless torch sees one
    (decided here, never at import)."""
    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test uploads to the card")
    return torch.device(dev)


@pytest.fixture
def card():
    return _on("cuda")


DEVICES = ["cpu", pytest.param("cuda", id="card", marks=pytest.mark.card)]


def _umi_offsets(lens: np.ndarray, seed: int) -> np.ndarray:
    """Non-zero int64 UMI offsets of 1-8 bases, none past its read's length,
    as ``process_umi`` gives them (cast to int32 on the way)."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.integers(1, 9, len(lens)), lens).astype(np.int64)


def _se_arrays(rows: int, seed: int = 5, umi: bool = False):
    """A single-end chunk as the runner dispatches it: (seq, qual) planes
    152 wide with zero padding past each length, int64 lengths and UMI
    offsets (zero, or non-zero with ``umi``), the index filter's keep."""
    rng = np.random.default_rng(seed)
    s, q, _ = make_reads(rows, seed)
    lens = np.where(rng.random(rows) < 0.3, rng.integers(0, 152, rows), 151)
    pad = np.arange(152)[None, :] >= lens[:, None]
    seq = np.where(pad, 0, np.pad(s, ((0, 0), (0, 1)))).astype(np.uint8)
    qual = np.where(pad, 0, np.pad(q, ((0, 0), (0, 1)))).astype(np.uint8)
    start0 = _umi_offsets(lens, seed + 100) if umi else np.zeros(rows, np.int64)
    return seq, qual, lens, start0, rng.random(rows) < 0.95


def _pe_arrays(rows: int, seed: int = 6, umi: bool = False):
    """A paired-end chunk as the runner dispatches it: (seq, qual, lens) of
    each mate, widths 152 and 104, then the UMI offsets (zero, or non-zero
    with ``umi``) and keep."""
    rng = np.random.default_rng(seed)
    s1, q1, s2, q2, _ = make_pairs(rows, seed, 151, adapters=True)
    planes = []
    for s, q, w in ((s1, q1, 152), (s2[:, :100], q2[:, :100], 104)):
        L = s.shape[1]
        ln = np.where(rng.random(rows) < 0.3, rng.integers(0, L + 1, rows), L)
        pad = np.arange(w)[None, :] >= ln[:, None]
        planes += [np.where(pad, 0, np.pad(x, ((0, 0), (0, w - L)))).astype(np.uint8)
                   for x in (s, q)] + [ln.astype(np.int32)]
    if umi:
        starts = [_umi_offsets(planes[2], seed + 100),
                  _umi_offsets(planes[5], seed + 101)]
    else:
        starts = [np.zeros(rows, np.int64)] * 2
    return planes + starts + [rng.random(rows) < 0.97]


def _plane_set(name: str, rows: int) -> tuple:
    """A chunk's row planes as runner.py and pe_runner.py pass them to
    ``dispatch``: ``raw`` with zero UMI offsets, ``umi`` with non-zero ones,
    ``part`` the middle one of three parts of a ``umi`` chunk of
    ``3 * rows + 1`` rows, the row slice ``dispatch_sharded`` hands over."""
    mode, kind = name.split("_")
    make = _se_arrays if mode == "se" else _pe_arrays
    if kind == "part":
        lo, hi = row_bounds(3 * rows + 1, 3)[1]
        return tuple(a[lo:hi] for a in make(3 * rows + 1, umi=True))
    return tuple(make(rows, umi=kind == "umi"))


def _planes_out(*xs) -> dict:
    """A body that returns the planes it was handed."""
    return {str(i): x for i, x in enumerate(xs)}


PLANE_SETS = ["se_raw", "pe_raw", "se_umi", "pe_umi", "se_part", "pe_part"]


@pytest.mark.parametrize("rows", [0, 1, 37])
def test_arena_layout(rows):
    """Every array at a multiple of 256 bytes, in order, without overlap, at
    its size; uint8 and bool kept, int64 vectors as int32; the views of the
    upload at those offsets of the arena (on the CPU the arena is the
    device's buffer), with the shapes and dtypes of ``host_planes``."""
    arrays = _se_arrays(rows) + (np.arange(32, dtype=np.uint8),)
    slots, nbytes = device.arena_layout(arrays)
    assert [dt for _, _, dt, _ in slots] == [np.uint8, np.uint8, np.int32, np.int32,
                                          np.bool_, np.uint8]
    end = 0
    for a, (off, n, dt, shape) in zip(arrays, slots):
        assert off % device.ALIGN == 0 and off >= end and shape == a.shape
        assert n == a.size * dt.itemsize
        end = off + n
    assert nbytes == end
    arena, got_slots = device.pack(arrays, "cpu")
    assert got_slots == slots and arena.dtype == torch.uint8
    assert arena.numel() == nbytes and not arena.is_pinned()
    views = device.upload(arena, slots, "cpu")
    for v, h, (off, _, _, _) in zip(views, host_planes(arrays), slots):
        assert v.dtype == torch.from_numpy(h).dtype and tuple(v.shape) == h.shape
        assert v.is_contiguous()
        if v.numel():
            assert v.data_ptr() - arena.data_ptr() == off
        np.testing.assert_array_equal(v.numpy(), h)


@pytest.mark.parametrize("name", PLANE_SETS)
def test_dispatch_views_equal_host_planes(name):
    """Every plane set the runners dispatch (non-zero int64 UMI offsets and
    a split part's row slice included) reaches the body as views equal to
    ``host_planes`` in value, dtype and shape; a chunk of no rows too."""
    for rows in (0, 45):
        arrays = _plane_set(name, rows)
        got = dispatch(_planes_out, arrays, "cpu").get()
        want = host_planes(arrays)
        assert len(got) == len(want)
        for i, h in enumerate(want):
            assert got[str(i)].dtype == h.dtype and got[str(i)].shape == h.shape
            np.testing.assert_array_equal(got[str(i)], h, err_msg=f"{name} {i}")


@pytest.mark.parametrize("k", [2, 3, 8])
def test_dispatch_on_parts_uploads_each_part(k):
    """``dispatch_on`` over k CPU devices uploads one arena a part with rows
    (one for a chunk of none), of that part's bytes, and the parts' views,
    joined in row order, equal ``host_planes`` of the whole chunk (the join
    checks each part's row count); a chunk of fewer rows than devices too."""
    devices = [torch.device("cpu")] * k
    for name, rows in (("pe_umi", 45), ("se_umi", k - 1), ("se_raw", 0)):
        arrays = _plane_set(name, rows)
        bounds = [(lo, hi) for lo, hi in row_bounds(rows, k) if hi > lo] or [(0, 0)]
        device.staged.clear()
        got = dispatch_on(devices, _planes_out, arrays).get()
        assert dict(device.staged) == {
            "chunks": _parts(rows, k), "pinned": 0,
            "bytes": sum(device.arena_layout([a[lo:hi] for a in arrays])[1]
                         for lo, hi in bounds)}, name
        want = host_planes(arrays)
        assert len(got) == len(want)
        for i, h in enumerate(want):
            assert got[str(i)].dtype == h.dtype and got[str(i)].shape == h.shape
            np.testing.assert_array_equal(got[str(i)], h, err_msg=f"{name} {i}")


def test_staged_counts_each_dispatch():
    """One chunk and its arena's bytes a ``dispatch``, none of them pinned on
    the CPU."""
    device.staged.clear()
    nbytes = 0
    for name, rows in (("se_raw", 64), ("pe_umi", 33), ("se_part", 0)):
        arrays = _plane_set(name, rows)
        dispatch(lambda *xs: {"n": xs[0]}, arrays, "cpu").get()
        nbytes += device.arena_layout(arrays)[1]
    assert dict(device.staged) == {"chunks": 3, "pinned": 0, "bytes": nbytes}


@pytest.mark.card
def test_card_arena_is_page_locked(card):
    """On a card every upload's arena is page-locked, and the body sees the
    chunk's values; a chunk of no rows still runs."""
    device.staged.clear()
    for name, rows in (("se_raw", 4096), ("pe_raw", 1000), ("pe_umi", 77)):
        arrays = _plane_set(name, rows)
        got = dispatch(_planes_out, arrays, card).get()
        for i, h in enumerate(host_planes(arrays)):
            np.testing.assert_array_equal(got[str(i)], h, err_msg=f"{name} {i}")
    assert device.staged["chunks"] == 3
    assert device.staged["pinned"] == device.staged["chunks"]
    empty = dispatch(lambda *xs: {"n": xs[0].sum()}, _plane_set("se_raw", 0),
                     card).get()
    assert int(empty["n"]) == 0 and device.staged["chunks"] == 4


def _one_copy_a_plane(body, arrays, dev, **kw) -> dict:
    """``body`` fed each plane as its own tensor on ``dev`` (on a card one
    pageable copy a plane): the dispatch the arena replaced."""
    planes = [torch.as_tensor(a).to(dev, non_blocking=True)
              for a in host_planes(arrays)]
    return outputs_to_numpy(body(*planes, **kw))


PE_FLAGS = ["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq", "-O", "o2.fq"]
# mode, flags, the single-end call's arguments beyond ``p``
PIPELINE_CASES = {
    "se_all": ("se", ["-q", "-g", "-a", "--adapter_of_read1", ADAPTER_R1.decode(),
                      "-d", "--kmer"], dict(adapter_r1=ADAPTER_R1, with_kmer=True)),
    "pe_merge_corr": ("pe", ["-q", "-m", "--merge_output", "m.fq", "-c"], {}),
    "pe_full": ("pe", ["-q", "--kmer", "-d", "-a", "--detect_pe_adapter"], {}),
    "se_chip75": ("se", CELL_ARGV["se_fastp_default"][2:-4],
                  dict(adapter_r1=ADAPTER)),
    "se_umi": ("se", ["-q", "-g", "-x", "-d"], dict(use_start0=True)),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
@pytest.mark.parametrize("dev", DEVICES)
def test_pipeline_call_equals_body_on_host_planes(dev, case):
    """``se_pipeline_call``/``pe_pipeline_call`` (the arena) equal to the
    same pipeline fed one copy a plane, key by key: on the CPU and on a
    card, where the arena is page-locked and the copy pageable."""
    dev = _on(dev)
    mode, flags, extra = PIPELINE_CASES[case]
    rows = 16384 if dev.type == "cuda" else 2048
    if mode == "se":
        arrays = _se_arrays(rows, umi=extra.get("use_start0", False))
        kw = dict(p=kernel_params_se(*flags), **extra)
        got = se_pipeline_call(arrays, dev, **kw).get()
        ref = _one_copy_a_plane(se_pipeline, arrays, dev, **kw)
    else:
        arrays = _pe_arrays(rows)
        opt = _options(PE_FLAGS + flags)
        kw = dict(p=opt.kernel_params(is_r2=False), p2=opt.kernel_params(is_r2=True),
                  **pipeline_args(opt))
        got = pe_pipeline_call(arrays, dev, **kw).get()
        ref = _one_copy_a_plane(pe_pipeline, arrays, dev, **kw)
    same_outputs(f"{case} on {dev}", ref, got)


@pytest.mark.parametrize("mode", ["se", "pe"])
@pytest.mark.parametrize("dev", DEVICES)
def test_arena_views_keep_kernel_alignment(dev, mode):
    """Every view of the arena starts at a multiple of 16 bytes, and the
    overlap kernel's (8, 1) and the stats kernel's (16, 8, 1) load widths on
    its uint8 planes equal those on planes allocated one by one."""
    dev = _on(dev)
    arrays = _plane_set(f"{mode}_raw", 16384)
    views = device.to_device(arrays, dev)
    alone = [torch.tensor(a, device=dev) for a in host_planes(arrays)]
    for v, a in zip(views, alone):
        assert v.data_ptr() % 16 == 0
        if v.dim() == 2:
            L = v.shape[1]
            for widths in ((8, 1), stats_cuda.VECTOR_WIDTHS):
                assert (vector_width(v.data_ptr(), L, widths)
                        == vector_width(a.data_ptr(), L, widths))
