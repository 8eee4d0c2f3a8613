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
- ``FQTOOL_TPU_PROFILE_DIR`` writing a trace of a CPU run.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from fqtool_tpu.ops import packed as jpacked
from fqtool_tpu_torch.host import linkprobe
from fqtool_tpu_torch.io import native
from fqtool_tpu_torch.ops import packed
from fqtool_tpu_torch.pipeline import blob, runner
from fqtool_tpu_torch.pipeline.device import dispatch

from .test_torch_cli import _compare_outputs, _run
from .test_torch_pe_pipeline import assert_same_outputs
from .torch_multihost import assert_same_bytes
from .torch_pairs import random_batch, write_pairs
from .torch_reads import QUAL_BIN_TABLE, bin_qualities, write_reads


@pytest.mark.parametrize("numpy_path", [False, True])
def test_encoders_equal_jax_and_decoders_invert_them(monkeypatch, numpy_path):
    import jax.numpy as jnp

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
    from .torch_pairs import _options
    from fqtool_tpu_torch.pipeline.pe import pe_pipeline_call
    from fqtool_tpu_torch.pipeline.pe_runner import pipeline_args
    from fqtool_tpu_torch.pipeline.se import se_pipeline_call

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
