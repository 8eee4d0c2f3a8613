"""ctypes binding of the CUDA overlap kernel (``csrc/overlap.cu``).

The shared library is built with ``nvcc`` for ``sm_90a`` at first use, from
the package's own source, into ``build/torch_kernels/`` at the repository
root, keyed by a hash of the source; a build failure raises, and nvcc's
output (ptxas's register and spill counts included) is kept beside the
library as ``liboverlap.log``.  The wrapper
checks its inputs, allocates the outputs (a bool plane and one int32 [3, B]
plane, which the kernel fills directly), picks the widest load that each
plane's address and row width allow, launches on PyTorch's current stream,
raises on a nonzero ``cudaGetLastError()`` and counts its launches in the
module-level ``launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from .overlap import OverlapResult

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "overlap.cu"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = 0  # kernel launches made by analyze_cuda since the last reset

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build "
                           f"{_SRC.name}")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"overlap-{digest}" / "liboverlap.so"


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            # build into a temporary name, then rename: concurrent builders
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {_SRC.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.fq_overlap_launch.restype = ctypes.c_int
        lib.fq_overlap_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
        _lib = lib
        return lib


def vector_width(ptr: int, width: int) -> int:
    """The kernel's load width for a row-major uint8 plane at address ``ptr``
    with ``width``-byte rows: 8 bytes where every row starts 8-aligned, else
    1 (bytewise)."""
    return 8 if ptr % 8 == 0 and width % 8 == 0 else 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def analyze_cuda(seq1: torch.Tensor, rlen1: torch.Tensor,
                 seq2: torch.Tensor, rlen2: torch.Tensor,
                 diff_limit: int, overlap_require: int) -> OverlapResult:
    """The kernel's wrapper: same contract as ``overlap.analyze`` for CUDA
    tensors (uint8 [B, L1] / [B, L2] contiguous rows, int32 [B] lengths)."""
    global launches
    dev = seq1.device
    if dev.type != "cuda":
        raise ValueError(f"analyze_cuda needs CUDA tensors, got {dev}")
    _check("seq1", seq1, torch.uint8, 2, dev)
    _check("seq2", seq2, torch.uint8, 2, dev)
    _check("rlen1", rlen1, torch.int32, 1, dev)
    _check("rlen2", rlen2, torch.int32, 1, dev)
    B, L1 = seq1.shape
    L2 = seq2.shape[1]
    if seq2.shape[0] != B or rlen1.shape[0] != B or rlen2.shape[0] != B:
        raise ValueError("seq1, seq2, rlen1 and rlen2 disagree on the batch size")
    overlapped = torch.empty((B,), dtype=torch.bool, device=dev)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    if B > 0:
        lib = build()
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
