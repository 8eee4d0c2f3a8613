"""ctypes binding of the CUDA overlap kernel (``csrc/overlap.cu``).

The library is built and loaded by ``kernel_lib`` (nvcc for ``sm_90a`` at
first use, into ``build/torch_kernels/``, with ``liboverlap.log`` beside
it).  The wrapper checks its inputs, allocates the outputs (a bool plane and
one int32 [3, B] plane, which the kernel fills directly), picks the widest
load that each plane's address and row width allow, launches on PyTorch's
current stream, raises on a nonzero ``cudaGetLastError()`` and counts its
launches in the module-level ``launches``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import kernel_lib
from .kernel_lib import check, vector_width
from .overlap import OverlapResult

launches = 0  # kernel launches made by analyze_cuda since the last reset


def _declare(lib: ctypes.CDLL) -> None:
    lib.fq_overlap_launch.restype = ctypes.c_int
    lib.fq_overlap_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])


library = kernel_lib.Library(
    Path(__file__).resolve().parent.parent / "csrc" / "overlap.cu", _declare)


def analyze_cuda(seq1: torch.Tensor, rlen1: torch.Tensor,
                 seq2: torch.Tensor, rlen2: torch.Tensor,
                 diff_limit: int, overlap_require: int) -> OverlapResult:
    """The kernel's wrapper: same contract as ``overlap.analyze`` for CUDA
    tensors (uint8 [B, L1] / [B, L2] contiguous rows, int32 [B] lengths)."""
    global launches
    dev = seq1.device
    if dev.type != "cuda":
        raise ValueError(f"analyze_cuda needs CUDA tensors, got {dev}")
    check("seq1", seq1, torch.uint8, 2, dev)
    check("seq2", seq2, torch.uint8, 2, dev)
    check("rlen1", rlen1, torch.int32, 1, dev)
    check("rlen2", rlen2, torch.int32, 1, dev)
    B, L1 = seq1.shape
    L2 = seq2.shape[1]
    if seq2.shape[0] != B or rlen1.shape[0] != B or rlen2.shape[0] != B:
        raise ValueError("seq1, seq2, rlen1 and rlen2 disagree on the batch size")
    overlapped = torch.empty((B,), dtype=torch.bool, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    if B > 0:
        lib = library.load()
        p1, p2 = seq1.data_ptr(), seq2.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fq_overlap_launch(
                p1, p2, rlen1.data_ptr(), rlen2.data_ptr(), B, L1, L2,
                vector_width(p1, L1), vector_width(p2, L2), int(diff_limit),
                int(overlap_require), overlapped.data_ptr(), out.data_ptr(),
                dev.index, stream)
        if err != 0:
            raise RuntimeError(f"overlap kernel launch failed: CUDA error {err}")
        launches += 1
    offset, olen, diff = out
    return OverlapResult(overlapped, offset, olen, diff)
