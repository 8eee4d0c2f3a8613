"""Build and load the port's CUDA kernels (``csrc/*.cu``) for ctypes.

Each kernel source is built with ``nvcc`` for ``sm_90a`` at first use into
``build/torch_kernels/<stem>-<hash>/lib<stem>.so`` at the repository root,
keyed by a hash of the source and the flags; a build failure raises, and
nvcc's output (ptxas's register and spill counts included) is kept beside
the library as ``lib<stem>.log``.  The wrappers (``overlap_cuda.py``,
``stats_cuda.py``) share the input checks and the choice of load width.
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
from typing import Callable, Optional, Sequence

import torch

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc(src: Path) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): cannot build "
                           f"{src.name}")
    return found


class Library:
    """The kernel library of ``src``, built (once per source hash) under
    ``build_root`` and loaded at the first ``load``; ``declare`` sets the
    argtypes and restype of its C functions."""

    def __init__(self, src: Path, declare: Callable[[ctypes.CDLL], None],
                 build_root: Path = BUILD_ROOT):
        self.src = src
        self.build_root = build_root
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        digest = hashlib.sha256(self.src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        stem = self.src.stem
        return self.build_root / f"{stem}-{digest}" / f"lib{stem}.so"

    def load(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is not None:
                return self._lib
            so = self.path()
            if not so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                # build into a temporary name, then rename: concurrent
                # builders never load a half-written library
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
                os.close(fd)
                cmd = [_nvcc(self.src), *NVCC_FLAGS, "-o", tmp, str(self.src)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"nvcc failed for {self.src.name}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._declare(lib)
            self._lib = lib
            return lib


def vector_width(ptr: int, width: int, widths: Sequence[int] = (8, 1)) -> int:
    """The widest of ``widths`` (descending, ending in 1) at which a
    row-major uint8 plane at address ``ptr`` with ``width``-byte rows can be
    loaded: every row has to start at a multiple of it."""
    return next(w for w in widths if ptr % w == 0 and width % w == 0)


def check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """Raise ValueError unless ``t`` is a contiguous ``ndim``-d ``dtype``
    tensor on ``device``."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
