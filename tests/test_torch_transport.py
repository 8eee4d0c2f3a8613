"""The transport paths of fqtool_tpu_torch against fqtool_tpu's.

- ``ops/packed.py``: the host encoders equal the JAX module's, and
  ``decode_device``/``decode5_device`` equal JAX's on the same planes (every
  byte value included) and give back the original planes;
- ``pipeline/blob.py``: the three cases of ``tests/test_input_blob.py`` on
  the port's one-blob dispatch, and the pipelines' output dicts through it;
- ``host/linkprobe.py``: the four cases of ``tests/test_linkprobe.py``;
- the CLI under ``FQTOOL_TPU_PACKED=1`` with ``FQTOOL_TPU_PACKED5`` 1 and 0,
  ``FQTOOL_TPU_INBLOB=1``, ``FQTOOL_TPU_PACK_OVERLAP=1`` and
  ``FQTOOL_TPU_HEADCACHE=0``, single-end and paired-end: byte for byte equal
  to the port's default run, and record for record, report for report equal
  to ``fqtool_tpu.main`` under the same variable (on one device, where its
  input blob is not overridden by a mesh).  The inputs have binned
  qualities (six values), so the 5-bit transport takes every pack; packs of
  128-256 records, so the cross-pack overlap has packs to overlap;
  ``--ora`` with ``FQTOOL_TPU_HEADCACHE=0``, so the head cache is on in its
  default run;
- ``FQTOOL_TPU_PROFILE_DIR`` writing a trace of a CPU run;
- ``pipeline/device.py``'s arena (``pack``/``upload``): the layout, the
  typed views of every plane set the runners dispatch against
  ``host_planes``, and the ``staged`` counter.  Marked ``card`` (they skip
  where torch sees no CUDA card): the arena page-locked on every upload,
  ``se_pipeline_call``/``pe_pipeline_call`` on the card equal to the
  pipelines fed by one pageable copy a plane, and the kernels' load widths
  on the arena's views equal to those on planes allocated one by one.  JAX
  is imported inside the tests that compare with it, so on the card this
  file runs as

    python -m pytest -p no:cacheprovider --noconftest -m card tests/test_torch_transport.py
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from fqtool_tpu_torch.entry import assert_same_outputs as same_outputs
from fqtool_tpu_torch.host import linkprobe
from fqtool_tpu_torch.io import native
from fqtool_tpu_torch.ops import packed, stats_cuda
from fqtool_tpu_torch.ops.kernel_lib import vector_width
from fqtool_tpu_torch.pipeline import blob, device, runner
from fqtool_tpu_torch.pipeline.device import dispatch, host_planes, outputs_to_numpy
from fqtool_tpu_torch.pipeline.pe import pe_pipeline, pe_pipeline_call
from fqtool_tpu_torch.pipeline.pe_runner import pipeline_args
from fqtool_tpu_torch.pipeline.se import se_pipeline, se_pipeline_call

from .test_torch_cli import _compare_outputs, _run
from .torch_multihost import assert_same_bytes
from .torch_pairs import (ADAPTER_R1, _options, kernel_params_se, make_pairs,
                          random_batch, write_pairs)
from .torch_reads import QUAL_BIN_TABLE, bin_qualities, make_reads, write_reads


@pytest.mark.parametrize("numpy_path", [False, True])
def test_encoders_equal_jax_and_decoders_invert_them(monkeypatch, numpy_path):
    import jax.numpy as jnp
    from fqtool_tpu.ops import packed as jpacked

    if numpy_path:  # the numpy code instead of the native single pass
        monkeypatch.setattr(native, "get_lib", lambda: None)
    seq, qual, _ = random_batch(np.random.default_rng(3), 300, 152)
    qual = np.minimum(qual, 33 + 49)  # inside the encodable range
    enc = packed.encode_host(seq, qual)
    np.testing.assert_array_equal(enc, jpacked._ENC_LUT[seq, qual])
    for dec in (packed.decode_device(torch.as_tensor(enc)),
                jpacked.decode_device(jnp.asarray(enc))):
        np.testing.assert_array_equal(np.asarray(dec[0]), seq)
        np.testing.assert_array_equal(np.asarray(dec[1]), qual)
    # six quality values: the 5-bit form fits; 45 values: it does not
    enc_b = packed.encode_host(seq, QUAL_BIN_TABLE[qual])
    got = packed.encode5_host(enc_b)
    assert got is not None and packed.encode5_host(enc) is None
    p5, d32 = got
    for width in (152, 150):
        s, q = packed.decode5_device(torch.as_tensor(p5), torch.as_tensor(d32), width)
        js, jq = jpacked.decode5_device(jnp.asarray(p5), jnp.asarray(d32), width)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), seq[:, :width])
        np.testing.assert_array_equal(q.numpy(), QUAL_BIN_TABLE[qual][:, :width])


def test_decode_device_equals_jax_on_every_byte():
    import jax.numpy as jnp
    from fqtool_tpu.ops import packed as jpacked

    enc = np.random.default_rng(1).integers(0, 256, (64, 40)).astype(np.uint8)
    enc[0, :] = np.arange(40)
    enc[1:8].reshape(-1)[:216] = np.arange(40, 256)
    s, q = packed.decode_device(torch.as_tensor(enc))
    js, jq = jpacked.decode_device(jnp.asarray(enc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.dtype == torch.uint8 and q.dtype == torch.uint8


# --- tests/test_input_blob.py, ported ---------------------------------------
def _mk_args(rng, n, width):
    seq = rng.integers(65, 85, (n, width)).astype(np.uint8)
    qual = rng.integers(33, 74, (n, width)).astype(np.uint8)
    lens = rng.integers(1, width + 1, n).astype(np.int32)
    keep = rng.random(n) < 0.8
    real = np.ones(n, bool)
    return (seq, qual, lens, keep, real)


def _body(seq, qual, lens, keep, real, scale=1):
    return {
        "s": (seq.to(torch.int32) * scale).sum(dim=1),
        "q": qual,
        "mask": keep & real,
        "lens": lens * 2,
    }


@pytest.mark.parametrize("n", [64, 41])
def test_dispatch_blob_matches_per_array(n, monkeypatch):
    args = _mk_args(np.random.default_rng(n), n, 37)
    monkeypatch.setenv("FQTOOL_TPU_INBLOB", "0")
    ref = dispatch(_body, args, "cpu", scale=3).get()
    monkeypatch.setenv("FQTOOL_TPU_INBLOB", "1")
    res = dispatch(_body, args, "cpu", scale=3)
    assert isinstance(res, blob.BlobResult)
    got = res.get()
    assert set(ref) == set(got)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_dispatch_blob_aux_args_not_padded(monkeypatch):
    rng = np.random.default_rng(3)
    args = _mk_args(rng, 20, 11)
    lut = rng.integers(0, 255, 32).astype(np.uint8)

    def body(seq, qual, lens, keep, real, lut):
        return {"x": seq.to(torch.int32) + lut.to(torch.int32)[0],
                "lut_sum": lut.to(torch.int32).sum()}

    monkeypatch.setenv("FQTOOL_TPU_INBLOB", "0")
    ref = dispatch(body, args, "cpu", aux=(lut,)).get()
    monkeypatch.setenv("FQTOOL_TPU_INBLOB", "1")
    got = dispatch(body, args, "cpu", aux=(lut,)).get()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    assert int(got["lut_sum"]) == int(lut.astype(np.int64).sum())


def test_pack_roundtrip_spec():
    from fqtool_tpu.pipeline import blob as jblob

    rows, width = 16, 9
    args = _mk_args(np.random.default_rng(0), 11, width)
    spec, sections = blob._build_input_spec(rows, args)
    host = blob.pack_input_blob(args, spec, sections)
    jspec, jsections = jblob._build_input_spec(rows, args)
    assert (spec, sections) == (jspec, jsections)
    np.testing.assert_array_equal(host, jblob.pack_input_blob(args, jspec, jsections))
    got = blob.unblob_inputs(torch.as_tensor(host), spec, sections)
    for a, g in zip(args, got):
        want = np.zeros((rows,) + a.shape[1:], a.dtype)
        want[: a.shape[0]] = a
        np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_pipeline_outputs_through_the_blob(monkeypatch, mode):
    """Every output kind of both pipelines (NamedTuples, a None field,
    uint32, int16, 0-d sums) survives ``blobify``/``unblobify``."""
    from . import test_torch_pe_pipeline as pe_case
    from . import test_torch_se_pipeline as se_case
    from .test_torch_pe_pipeline import assert_same_outputs

    def call():
        if mode == "se":
            seq, qual, lens, keep = se_case.chunk(4, 96)
            return se_pipeline_call(
                (seq, qual, lens, np.zeros(96, np.int32), keep), "cpu",
                se_case.kernel_params_se(*se_case.ALL), adapter_r1=se_case.ADAPTER,
                with_kmer=True)
        planes, start1, start2, keep = pe_case.chunk(5, 96)
        opt = _options(pe_case.PE + pe_case.CASES["umi-per-read-all"])
        return pe_pipeline_call(planes + [start1, start2, keep], "cpu",
                                opt.kernel_params(is_r2=False),
                                opt.kernel_params(is_r2=True), **pipeline_args(opt))

    monkeypatch.setenv("FQTOOL_TPU_INBLOB", "0")
    ref = call().get()
    monkeypatch.setenv("FQTOOL_TPU_INBLOB", "1")
    assert_same_outputs(ref, call().get())


# --- tests/test_linkprobe.py, ported ----------------------------------------
def test_env_forces(monkeypatch):
    monkeypatch.setenv("FQTOOL_TPU_PACKED", "1")
    assert linkprobe.use_packed("cpu") is True
    monkeypatch.setenv("FQTOOL_TPU_PACKED", "0")
    assert linkprobe.use_packed("cpu") is False


def test_auto_fast_link_disables(monkeypatch):
    monkeypatch.delenv("FQTOOL_TPU_PACKED", raising=False)
    monkeypatch.setattr(linkprobe, "_cached", None)
    # in-process CPU "transfers" run at memcpy speed, far above the threshold
    assert linkprobe.use_packed("cpu") is False
    assert linkprobe._cached is False


def test_auto_slow_link_enables(monkeypatch):
    monkeypatch.delenv("FQTOOL_TPU_PACKED", raising=False)
    monkeypatch.setattr(linkprobe, "_cached", None)
    monkeypatch.setattr(linkprobe, "_probe_mbps", lambda device: 50.0)
    assert linkprobe.use_packed("cpu") is True


def test_probe_measures_something():
    assert linkprobe._probe_mbps("cpu") > 0.0


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
def test_cli_transport_switch(tmp_path, monkeypatch, capfd, variant, mode):
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
    runner.transport_chunks.clear()
    for k, v in VARIANTS[variant].items():
        monkeypatch.setenv(k, v)
    capfd.readouterr()
    assert _run(torch_main, argv, tmp_path / "torch") == 0
    assert _run(jax_main, argv, tmp_path / "jax") == 0
    chunks = dict(runner.transport_chunks)
    want = {"packed5": "b5", "packed8": "b8"}.get(variant, "raw")
    assert set(chunks) == {want} and chunks[want] >= 3, chunks
    assert_same_bytes(tmp_path / "default", tmp_path / "torch")
    _, _, n = _compare_outputs(tmp_path)
    assert n > 0


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
@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test uploads to the card")
    return torch.device("cuda")


def _se_arrays(rows: int, seed: int = 5):
    """A single-end chunk as the runner dispatches it: (seq, qual) planes
    152 wide with zero padding past each length, int64 lengths and UMI
    offsets (cast to int32 on the way), the index filter's keep."""
    rng = np.random.default_rng(seed)
    s, q, _ = make_reads(rows, seed)
    lens = np.where(rng.random(rows) < 0.3, rng.integers(0, 152, rows), 151)
    pad = np.arange(152)[None, :] >= lens[:, None]
    seq = np.where(pad, 0, np.pad(s, ((0, 0), (0, 1)))).astype(np.uint8)
    qual = np.where(pad, 0, np.pad(q, ((0, 0), (0, 1)))).astype(np.uint8)
    return seq, qual, lens, np.zeros(rows, np.int64), rng.random(rows) < 0.95


def _pe_arrays(rows: int, seed: int = 6):
    """A paired-end chunk as the runner dispatches it: (seq, qual, lens) of
    each mate, widths 152 and 104, then the UMI offsets and keep."""
    rng = np.random.default_rng(seed)
    s1, q1, s2, q2, _ = make_pairs(rows, seed, 151, adapters=True)
    planes = []
    for s, q, w in ((s1, q1, 152), (s2[:, :100], q2[:, :100], 104)):
        L = s.shape[1]
        ln = np.where(rng.random(rows) < 0.3, rng.integers(0, L + 1, rows), L)
        pad = np.arange(w)[None, :] >= ln[:, None]
        planes += [np.where(pad, 0, np.pad(x, ((0, 0), (0, w - L)))).astype(np.uint8)
                   for x in (s, q)] + [ln.astype(np.int32)]
    zeros = np.zeros(rows, np.int64)
    return planes + [zeros, zeros, rng.random(rows) < 0.97]


def _plane_set(name: str, rows: int):
    """(row planes, aux) of one transport, as runner.py and pe_runner.py
    pass them to ``dispatch``: raw planes, the one-byte encoding (``b8``)
    or the 5-bit one with its dictionary as ``aux`` (``b5``)."""
    mode, transport = name.split("_")
    arrays = _se_arrays(rows) if mode == "se" else _pe_arrays(rows)
    if transport == "raw":
        return tuple(arrays), ()
    mates = [arrays[:2]] if mode == "se" else [arrays[0:2], arrays[3:5]]
    lens = [arrays[2]] if mode == "se" else [arrays[2], arrays[5]]
    rest = tuple(arrays[3:]) if mode == "se" else tuple(arrays[6:])
    row, aux = [], []
    for (s, q), ln in zip(mates, lens):
        enc = packed.encode_host(s, QUAL_BIN_TABLE[q])
        if transport == "b5":
            enc, d32 = packed.encode5_host(enc)
            aux.append(d32)
        row += [enc, ln]
    return tuple(row) + rest, tuple(aux)


PLANE_SETS = ["se_raw", "pe_raw", "se_b8", "se_b5", "pe_b8", "pe_b5"]


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
    """Every plane set the runners dispatch (the ``dict32`` aux of ``b5``
    included, in its own shape) reaches the body as views equal to
    ``host_planes`` in value, dtype and shape; a chunk of no rows too."""
    for rows in (0, 45):
        arrays, aux = _plane_set(name, rows)
        got = dispatch(lambda *xs: {str(i): x for i, x in enumerate(xs)},
                       arrays, "cpu", aux).get()
        want = host_planes(arrays + aux)
        assert len(got) == len(want)
        for i, h in enumerate(want):
            assert got[str(i)].dtype == h.dtype and got[str(i)].shape == h.shape
            np.testing.assert_array_equal(got[str(i)], h, err_msg=f"{name} {i}")


def test_staged_counts_each_dispatch(monkeypatch):
    """One chunk and its arena's bytes a ``dispatch``, none of them pinned on
    the CPU; the one-blob transport does not use the arena."""
    monkeypatch.delenv("FQTOOL_TPU_INBLOB", raising=False)
    device.staged.clear()
    nbytes = 0
    for name, rows in (("se_raw", 64), ("pe_b5", 33), ("se_b8", 0)):
        arrays, aux = _plane_set(name, rows)
        dispatch(lambda *xs: {"n": xs[0]}, arrays, "cpu", aux).get()
        nbytes += device.arena_layout(arrays + aux)[1]
    assert dict(device.staged) == {"chunks": 3, "pinned": 0, "bytes": nbytes}
    monkeypatch.setenv("FQTOOL_TPU_INBLOB", "1")
    dispatch(lambda *xs: {"n": xs[0]}, _plane_set("se_raw", 8)[0], "cpu").get()
    assert device.staged["chunks"] == 3


@pytest.mark.card
def test_card_arena_is_page_locked(card):
    """On a card every upload's arena is page-locked, and the body sees the
    chunk's values; a chunk of no rows still runs."""
    device.staged.clear()
    for name, rows in (("se_raw", 4096), ("pe_raw", 1000), ("pe_b5", 77)):
        arrays, aux = _plane_set(name, rows)
        got = dispatch(lambda *xs: {str(i): x for i, x in enumerate(xs)},
                       arrays, card, aux).get()
        for i, h in enumerate(host_planes(arrays + aux)):
            np.testing.assert_array_equal(got[str(i)], h, err_msg=f"{name} {i}")
    assert device.staged["chunks"] == 3
    assert device.staged["pinned"] == device.staged["chunks"]
    empty = dispatch(lambda *xs: {"n": xs[0].sum()}, _plane_set("se_raw", 0)[0],
                     card).get()
    assert int(empty["n"]) == 0 and device.staged["chunks"] == 4


def _pageable(body, arrays, card, **kw) -> dict:
    """``body`` fed the way ``dispatch`` fed it before the arena: one
    pageable copy a plane."""
    planes = [torch.as_tensor(a).to(card, non_blocking=True)
              for a in host_planes(arrays)]
    return outputs_to_numpy(body(*planes, **kw))


PE_FLAGS = ["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq", "-O", "o2.fq"]


@pytest.mark.card
@pytest.mark.parametrize("mode,flags", [
    ("se", ["-q", "-g", "-a", "--adapter_of_read1", ADAPTER_R1.decode(), "-d",
            "--kmer"]),
    ("pe", ["-q", "-m", "--merge_output", "m.fq", "-c"]),
    ("pe", ["-q", "--kmer", "-d", "-a", "--detect_pe_adapter"])])
def test_card_pipeline_equals_pageable_upload(card, mode, flags):
    """``se_pipeline_call``/``pe_pipeline_call`` on the card (the arena)
    equal to the same pipeline fed one pageable copy a plane, key by key."""
    if mode == "se":
        arrays = _se_arrays(16384)
        kw = dict(p=kernel_params_se(*flags), adapter_r1=ADAPTER_R1, with_kmer=True)
        got = se_pipeline_call(arrays, card, **kw).get()
        ref = _pageable(se_pipeline, arrays, card, **kw)
    else:
        arrays = _pe_arrays(16384)
        opt = _options(PE_FLAGS + flags)
        kw = dict(p=opt.kernel_params(is_r2=False), p2=opt.kernel_params(is_r2=True),
                  **pipeline_args(opt))
        got = pe_pipeline_call(arrays, card, **kw).get()
        ref = _pageable(pe_pipeline, arrays, card, **kw)
    same_outputs(f"{mode} {' '.join(flags)}", ref, got)


@pytest.mark.card
@pytest.mark.parametrize("name", ["se_raw", "pe_raw"])
def test_card_kernels_see_the_same_vector_width(card, name):
    """The overlap kernel's (8, 1) and the stats kernel's (16, 8, 1) load
    widths on the arena's uint8 planes equal those on planes allocated one
    by one, and every view starts at a multiple of 16 bytes."""
    arrays, _ = _plane_set(name, 16384)
    views = device.to_device(arrays, card)
    alone = [torch.as_tensor(a).to(card) for a in host_planes(arrays)]
    for v, a in zip(views, alone):
        assert v.data_ptr() % 16 == 0
        if v.dim() == 2:
            L = v.shape[1]
            for widths in ((8, 1), stats_cuda.VECTOR_WIDTHS):
                assert (vector_width(v.data_ptr(), L, widths)
                        == vector_width(a.data_ptr(), L, widths))
