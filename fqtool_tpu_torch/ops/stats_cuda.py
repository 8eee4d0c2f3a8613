"""ctypes binding of the CUDA per-cycle statistics kernel (``csrc/stats.cu``).

The library is built and loaded by ``kernel_lib`` (nvcc for ``sm_90a`` at
first use, into ``build/torch_kernels/``, with ``libstats.log`` beside it).
The wrapper checks its inputs, allocates one int32 output of 34 L + 2 words
(which the launcher zeroes and the kernel fills), picks the widest load that
the row width and both planes' addresses allow, launches on PyTorch's
current stream of the planes' device, raises on a nonzero CUDA error and
counts its launches in the module-level ``launches``: one per call with at
least one row.  ``stats.stat_batch`` makes the ``BatchStats`` views.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from . import kernel_lib
from .kernel_lib import check, vector_width

VECTOR_WIDTHS = (16, 8, 1)  # the kernel's instantiations

launches = 0  # kernel launches made by stat_batch_cuda since the last reset


def _declare(lib: ctypes.CDLL) -> None:
    lib.fq_stat_batch_launch.restype = ctypes.c_int
    lib.fq_stat_batch_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


library = kernel_lib.Library(
    Path(__file__).resolve().parent.parent / "csrc" / "stats.cu", _declare)


def stat_batch_cuda(seq: torch.Tensor, qual: torch.Tensor, rlen: torch.Tensor,
                    select: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's wrapper, for CUDA tensors: uint8 [B, L] contiguous seq
    and qual, L >= 1; int32 [B] rlen; bool [B] select or None.  Returns the
    int32 [34 L + 2] buffer: q20, q30, content and quality [8, L], then
    total and total_qual [L], reads and length_sum."""
    global launches
    dev = seq.device
    check("seq", seq, torch.uint8, 2, dev)
    check("qual", qual, torch.uint8, 2, dev)
    check("rlen", rlen, torch.int32, 1, dev)
    if select is not None:
        check("select", select, torch.bool, 1, dev)
    B, L = seq.shape
    if L < 1:
        raise ValueError("seq: rows of width 0")
    if qual.shape != seq.shape or rlen.shape[0] != B or \
            (select is not None and select.shape[0] != B):
        raise ValueError("seq, qual, rlen and select disagree on the shape")
    if dev.type != "cuda":
        raise ValueError(f"stat_batch_cuda needs CUDA tensors, got {dev}")
    if B == 0:
        return torch.zeros(34 * L + 2, dtype=torch.int32, device=dev)
    out = torch.empty(34 * L + 2, dtype=torch.int32, device=dev)
    lib = library.load()
    ps, pq = seq.data_ptr(), qual.data_ptr()
    vec = min(vector_width(ps, L, VECTOR_WIDTHS), vector_width(pq, L, VECTOR_WIDTHS))
    err = lib.fq_stat_batch_launch(
        ps, pq, rlen.data_ptr(), None if select is None else select.data_ptr(),
        B, L, vec, out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stat_batch kernel launch failed: CUDA error {err}")
    launches += 1
    return out
