"""Host <-> device transport shared by the single-end and paired-end
pipelines: upload of a chunk's numpy planes (packed into one byte arena,
page-locked for a card, and copied once), dispatch of a pipeline body on
one device, the handle over a dispatched chunk, and the conversion of its
output dict back to numpy (the JAX pipelines' host contract)."""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..host import tracing
from ..host.tracing import stage


ALIGN = 256  # bytes; every plane of an arena starts at a multiple of it

# every upload through an arena: "chunks" the uploads, "pinned" those whose
# arena was page-locked, "bytes" the arena bytes copied
staged: Counter = Counter()

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.bool_): torch.bool,
                 np.dtype(np.int32): torch.int32}


def _plane_dtype(a: np.ndarray) -> np.dtype:
    """uint8 and bool planes keep their dtype; integer vectors become int32."""
    return a.dtype if a.dtype in (np.uint8, np.bool_) else np.dtype(np.int32)


def host_planes(arrays: Sequence[np.ndarray]) -> list:
    """Numpy planes of a ReadPack slice as the device takes them: uint8 and
    bool planes keep their dtype, integer vectors become int32.  Slices may be
    read-only views, so each is copied into a contiguous array first."""
    return [np.ascontiguousarray(a, dtype=_plane_dtype(np.asarray(a)))
            for a in arrays]


def arena_layout(arrays: Sequence[np.ndarray]) -> Tuple[list, int]:
    """Where :func:`pack` puts each array in one byte arena: a list of
    (offset, bytes, dtype, shape), each offset a multiple of ``ALIGN`` and
    each dtype :func:`host_planes`' dtype, and the bytes in use (the end of
    the last array)."""
    slots, end = [], 0
    for a in arrays:
        dtype = _plane_dtype(a)
        off = -(-end // ALIGN) * ALIGN
        end = off + a.size * dtype.itemsize
        slots.append((off, end - off, dtype, a.shape))
    return slots, end


def pack(arrays: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, list]:
    """Write ``arrays`` into one host byte arena at :func:`arena_layout`'s
    offsets, integer vectors cast to int32 on the way; returns the arena and
    the layout.  For a card the arena is page-locked, from PyTorch's caching
    host allocator, which hands a block out again only once the copies
    recorded on it have completed; elsewhere it is plain host memory."""
    arrays = [np.asarray(a) for a in arrays]
    slots, nbytes = arena_layout(arrays)
    arena = torch.empty(nbytes, dtype=torch.uint8,
                        pin_memory=torch.device(device).type == "cuda")
    host = arena.numpy()
    for a, (off, n, dtype, shape) in zip(arrays, slots):
        np.copyto(host[off:off + n].view(dtype).reshape(shape), a, casting="unsafe")
    return arena, slots


def upload(arena: torch.Tensor, slots: list, device) -> tuple:
    """Enqueue the one copy of a :func:`pack` arena to ``device`` (none on
    the CPU, where the arena is the device's memory) and return each array
    as a typed view of the copy.  Counted in ``staged``."""
    buf = arena.to(device, non_blocking=True)
    staged["chunks"] += 1
    staged["pinned"] += int(arena.is_pinned())
    staged["bytes"] += arena.numel()
    return tuple(buf.narrow(0, off, n).view(_TORCH_DTYPES[dtype]).view(shape)
                 for off, n, dtype, shape in slots)


def to_device(arrays: Sequence[np.ndarray], device) -> tuple:
    """Numpy planes of a ReadPack slice -> tensors on ``device`` with
    :func:`host_planes`' dtypes (:func:`pack`, then :func:`upload`)."""
    return upload(*pack(arrays, device), device)


def on_device(device: torch.device):
    """Context that makes ``device`` current when it is a card, so that
    every launch, the overlap kernel's included, goes to its current
    stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def dispatch(body, arrays: Sequence[np.ndarray], device, **kw) -> "PipelineResult":
    """Upload one chunk's row planes ``arrays`` in one copy of a :func:`pack`
    arena, run ``body(*planes, **kw)`` on ``device`` and return the handle
    over its output, whose tensors are copied back one by one.  Traced: the
    stages ``dispatch_h2d`` (the packing and the upload) and
    ``dispatch_launch`` (the body's launches), and on a card the chunk's
    interval on the card's timeline (host/tracing.py)."""
    device = torch.device(device)
    with on_device(device):
        with stage("dispatch_h2d"):
            arena, slots = pack(arrays, device)
            # the chunk's start on the card, just before its upload
            begun = tracing.card_begin(device)
            planes = upload(arena, slots, device)
        with stage("dispatch_launch"):
            out = body(*planes, **kw)
        return PipelineResult(out, device, begun)


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, tuple):  # a NamedTuple of tensors (BatchStats, DupKeys)
        return type(x)(*(_to_numpy(v) for v in x))
    return x.cpu().numpy()


def outputs_to_numpy(out: Dict[str, object]) -> Dict[str, object]:
    """The pipeline's output dict with every tensor as a numpy array; a
    NamedTuple output is converted field by field and keeps its ``None``
    fields."""
    return {k: _to_numpy(v) for k, v in out.items()}


class PipelineResult:
    """Handle over one dispatched chunk.  ``get()`` may run on another thread
    than the dispatch (whose current stream is then a different one), so it
    waits on an event recorded on the launch stream before copying out.
    ``begun``: the chunk's start on the card's timeline
    (``tracing.card_begin``), which ``get()`` closes after the copies; the
    event is timing-enabled only then."""

    __slots__ = ("_out", "_stream", "_event", "_begun")

    def __init__(self, out, device: torch.device, begun=None):
        self._out = out
        self._stream = self._event = None
        self._begun = begun
        if device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._event = torch.cuda.Event(enable_timing=begun is not None)
            self._event.record(self._stream)

    def _fetch(self) -> Dict[str, object]:
        return outputs_to_numpy(self._out)

    def get(self) -> Dict[str, object]:
        if self._event is None:
            with stage("d2h"):
                return self._fetch()
        self._event.synchronize()
        with torch.cuda.stream(self._stream):
            with stage("d2h"):
                out = self._fetch()
            if self._begun is not None:
                tracing.card_end(self._begun, self._event, self._stream)
        return out
