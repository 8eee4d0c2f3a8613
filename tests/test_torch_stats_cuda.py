"""The per-cycle statistics kernel (``csrc/stats.cu`` via ``ops/stats_cuda.py``)
and ``stat_batch``'s dispatch by device.

On the CPU: ``stat_batch`` takes the plain torch path (no kernel launch) and
equals a direct numpy count of the contract on the inputs ``test_stat_batch``
leaves out (lengths below 0 and above L, bytes outside ACGTN, qualities
below '!'); the wrapper refuses CPU tensors, wrong dtypes and shapes; the
load widths of the test shapes cover every instantiation of the kernel.

Marked ``card`` (they skip where torch sees no CUDA card): the kernel against
the plain op run on the same tensors moved to the CPU, field by field and
exact (integer outputs), over batch sizes, widths (one past a block's tile
of 384 cycles), selections, lengths and bytes at their edges, and
non-contiguous or unaligned inputs; one launch a call; one ``pe_pipeline``
chunk on the card against the CPU, with 5 launches a chunk with the merge
and 4 without.  This file imports no JAX, so on the card it runs as

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_stats_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fqtool_tpu_torch.ops import stats, stats_cuda
from fqtool_tpu_torch.pipeline import pe as tpe
from fqtool_tpu_torch.pipeline.device import outputs_to_numpy, to_device
from fqtool_tpu_torch.pipeline.pe_runner import pipeline_args

from .torch_pairs import _options, make_pairs, plant_low_quality

BATCHES = (0, 1, 37, 16384)
WIDTHS = (1, 7, 36, 151, 152, 302, 304, 1000)  # 1000: three tiles of cycles
SELECTS = ("none", "all", "no", "random")


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the kernel on the card")
    return torch.device("cuda")


def edge_batch(rng, B: int, L: int, select: str):
    """seq bytes mostly ACGTN but any of 0-255; qualities mostly '!'-'J' but
    any of 0-255; lengths from -3 to L + 3 with 0, negative, L and above L on
    some rows; ``select`` none, all true, all false or random."""
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (B, L))]
    odd = rng.random((B, L)) < 0.05
    seq[odd] = rng.integers(0, 256, int(odd.sum()))
    qual = rng.integers(33, 75, (B, L)).astype(np.uint8)
    odd = rng.random((B, L)) < 0.05
    qual[odd] = rng.integers(0, 256, int(odd.sum()))
    rlen = rng.integers(-3, L + 4, B).astype(np.int32)
    for i, v in enumerate((0, -1, L, L + 1, -(2 ** 31), 2 ** 31 - 1)):
        if i < B:
            rlen[i] = v
    sel = {"none": None, "all": np.ones(B, bool), "no": np.zeros(B, bool),
           "random": rng.random(B) < 0.6}[select]
    return seq, qual, rlen, sel


def count(seq, qual, rlen, sel) -> dict:
    """The contract counted directly: a base at cycle c < rlen of a selected
    row counts in the bin (seq & 7, c)."""
    B, L = seq.shape
    on = np.ones(B, bool) if sel is None else sel
    live = (np.arange(L)[None, :] < rlen[:, None].astype(np.int64)) & on[:, None]
    q = qual.astype(np.int64)
    planes = {}
    for name, val in (("cycle_content", np.ones_like(q)), ("cycle_q20", q > 53),
                      ("cycle_q30", q > 63), ("cycle_quality", q - 33)):
        hist = np.zeros((8, L), np.int64)
        for b in range(8):
            hist[b] = np.where(live & ((seq & 7) == b), val, 0).sum(axis=0)
        planes[name] = hist.astype(np.int32)
    planes["cycle_total"] = planes["cycle_content"].sum(axis=0, dtype=np.int32)
    planes["cycle_total_qual"] = planes["cycle_quality"].sum(axis=0, dtype=np.int32)
    planes["reads"] = np.int32(on.sum())
    planes["length_sum"] = np.int64(rlen[on].astype(np.int64).sum()).astype(np.int32)
    return planes


def as_tensors(seq, qual, rlen, sel, device="cpu"):
    return tuple(None if a is None else torch.as_tensor(a).to(device)
                 for a in (seq, qual, rlen, sel))


def assert_same(ref: stats.BatchStats, got: stats.BatchStats, what: str) -> None:
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(got, name).cpu()
        assert b.dtype == a.dtype == torch.int32, f"{what} {name}: {b.dtype}"
        assert b.shape == a.shape, f"{what} {name}: {tuple(b.shape)}"
        assert torch.equal(a, b), \
            f"{what} {name}: first diffs at {torch.nonzero(a != b)[:5].tolist()}"


@pytest.mark.parametrize("select", SELECTS)
def test_stat_batch_dispatches_cpu_to_plain(select):
    seq, qual, rlen, sel = edge_batch(np.random.default_rng(7), 64, 41, select)
    before = stats_cuda.launches
    got = stats.stat_batch(*as_tensors(seq, qual, rlen, sel))
    assert stats_cuda.launches == before
    for name, want in count(seq, qual, rlen, sel).items():
        g = getattr(got, name)
        assert g.device.type == "cpu" and g.dtype == torch.int32, name
        assert np.array_equal(g.numpy(), want), name


def test_kernel_refuses_cpu_wrong_dtypes_and_shapes():
    seq, qual, rlen, sel = as_tensors(*edge_batch(np.random.default_rng(1), 8, 16,
                                                  "random"))
    call = stats_cuda.stat_batch_cuda
    with pytest.raises(ValueError, match="CUDA"):
        call(seq, qual, rlen, sel)
    with pytest.raises(ValueError, match="rlen: dtype"):
        call(seq, qual, rlen.long(), sel)
    with pytest.raises(ValueError, match="qual: dtype"):
        call(seq, qual.int(), rlen)
    with pytest.raises(ValueError, match="select: dtype"):
        call(seq, qual, rlen, sel.to(torch.uint8))
    with pytest.raises(ValueError, match="seq: 1-d"):
        call(seq.reshape(-1), qual, rlen)
    with pytest.raises(ValueError, match="not contiguous"):
        call(seq.t(), qual.t(), rlen)
    with pytest.raises(ValueError, match="disagree"):
        call(seq, qual[:4], rlen)
    with pytest.raises(ValueError, match="disagree"):
        call(seq, qual, rlen, sel[:4])


def test_load_widths_cover_every_instantiation():
    """Planes from the allocator start 16-aligned, so the test widths take
    every load width the kernel has; a plane one byte off loads bytewise."""
    vw = stats_cuda.vector_width
    widths = stats_cuda.VECTOR_WIDTHS
    assert {vw(512, L, widths) for L in WIDTHS} == set(widths)
    assert [vw(512, L, widths) for L in (152, 304, 302, 36)] == [8, 16, 1, 1]
    assert vw(513, 152, widths) == 1 and vw(520, 304, widths) == 8


@pytest.mark.card
@pytest.mark.parametrize("select", SELECTS)
@pytest.mark.parametrize("L", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
def test_kernel_matches_plain(card, B, L, select):
    args = edge_batch(np.random.default_rng(B * 1009 + L), B, L, select)
    ref = stats.stat_batch(*as_tensors(*args))
    before = stats_cuda.launches
    got = stats.stat_batch(*as_tensors(*args, device=card))
    torch.cuda.synchronize()
    assert stats_cuda.launches == before + (B > 0)
    assert got.cycle_q20.device.type == "cuda"
    assert_same(ref, got, f"B={B} L={L} select={select}")


@pytest.mark.card
@pytest.mark.parametrize("L", (7, 152, 302, 1000))
def test_kernel_on_strided_and_unaligned_inputs(card, L):
    """Column slices of wider planes, every other length and selection bit,
    and contiguous planes one byte off the allocator's alignment."""
    B = 999
    rng = np.random.default_rng(L)
    seq, qual, rlen, sel = edge_batch(rng, 2 * B, L + 5, "random")
    cpu = as_tensors(seq, qual, rlen, sel)
    dev = as_tensors(seq, qual, rlen, sel, device=card)
    sliced = [lambda t: t[:B, 3 : 3 + L], lambda t: t[:B, 3 : 3 + L],
              lambda t: t[::2], lambda t: t[::2]]
    ref = stats.stat_batch(*(f(t) for f, t in zip(sliced, cpu)))
    assert not dev[0][:B, 3 : 3 + L].is_contiguous()
    assert_same(ref, stats.stat_batch(*(f(t) for f, t in zip(sliced, dev))),
                f"strided L={L}")
    flat = [t.reshape(-1)[1 : 1 + B * L].view(B, L) for t in dev[:2]]
    assert flat[0].data_ptr() % 2 == 1
    ref = stats.stat_batch(*(t.cpu() for t in flat), cpu[2][:B], cpu[3][:B])
    assert_same(ref, stats.stat_batch(*flat, dev[2][:B], dev[3][:B]),
                f"unaligned L={L}")


PE = ["-i", "r1.fq", "-I", "r2.fq", "-o", "o1.fq", "-O", "o2.fq"]


@pytest.mark.card
@pytest.mark.parametrize("flags,calls", [
    (["-m", "--merge_output", "m.fq", "-c"], 5), (["-q", "-f", "3", "-t", "2"], 4)])
def test_pe_pipeline_chunk_on_the_card(card, flags, calls):
    """One chunk of 2 x 151 bp pairs in planes 152 wide through the paired-end
    pipeline on the card and on the CPU: every output equal, and one kernel
    launch per ``stat_batch`` call."""
    B = 4096
    rng = np.random.default_rng(11)
    s1, q1, s2, q2, _ = make_pairs(B, 11, 151)
    plant_low_quality(s1, q1, rng)
    plant_low_quality(s2, q2, rng)
    planes = []
    for s, q in ((s1, q1), (s2, q2)):
        ln = np.where(rng.random(B) < 0.2, rng.integers(0, 152, B), 151).astype(np.int32)
        pad = np.arange(152)[None, :] >= ln[:, None]
        planes += [np.where(pad, 0, np.pad(s, ((0, 0), (0, 1)))).astype(np.uint8),
                   np.where(pad, 0, np.pad(q, ((0, 0), (0, 1)))).astype(np.uint8), ln]
    zeros = np.zeros(B, np.int32)
    arrays = planes + [zeros, zeros, rng.random(B) < 0.97]
    opt = _options(PE + flags)
    kw = dict(p=opt.kernel_params(is_r2=False), p2=opt.kernel_params(is_r2=True),
              **pipeline_args(opt))
    ref = outputs_to_numpy(tpe.pe_pipeline(*to_device(arrays, "cpu"), **kw))
    before = stats_cuda.launches
    got = outputs_to_numpy(tpe.pe_pipeline(*to_device(arrays, card), **kw))
    assert stats_cuda.launches - before == calls
    assert sorted(got) == sorted(ref)
    for key, r in ref.items():
        g = got[key]
        pairs = zip(r._fields, r, g) if isinstance(r, tuple) else [("", r, g)]
        for field, a, b in pairs:
            assert (a is None) == (b is None), f"{key}.{field}"
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b), f"{key}.{field}"
