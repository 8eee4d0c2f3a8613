"""Host <-> device transport shared by the single-end and paired-end
pipelines: upload of a chunk's numpy planes, dispatch of a pipeline body on
one device, the handle over a dispatched chunk, and the conversion of its
output dict back to numpy (the JAX pipelines' host contract)."""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Sequence

import numpy as np
import torch

from ..host import tracing
from ..host.tracing import stage


def host_planes(arrays: Sequence[np.ndarray]) -> list:
    """Numpy planes of a ReadPack slice as the device takes them: uint8 and
    bool planes keep their dtype, integer vectors become int32.  Slices may be
    read-only views, so each is copied into a contiguous array first."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype not in (np.uint8, np.bool_):
            a = a.astype(np.int32)
        out.append(a)
    return out


def upload(planes: Sequence[np.ndarray], device) -> tuple:
    """Enqueue the copy of each of :func:`host_planes`' arrays to ``device``."""
    return tuple(torch.as_tensor(a).to(device, non_blocking=True) for a in planes)


def to_device(arrays: Sequence[np.ndarray], device) -> tuple:
    """Numpy planes of a ReadPack slice -> tensors on ``device``
    (:func:`host_planes`, then :func:`upload`)."""
    return upload(host_planes(arrays), device)


def on_device(device: torch.device):
    """Context that makes ``device`` current when it is a card, so that
    every launch, the overlap kernel's included, goes to its current
    stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def dispatch(body, arrays: Sequence[np.ndarray], device, aux: Sequence = (),
             **kw) -> "PipelineResult":
    """Upload one chunk's row planes ``arrays`` and the pack-level ``aux``
    arrays (which keep their own shape), run ``body(*planes, *aux, **kw)`` on
    ``device`` and return the handle over its output.  With
    ``FQTOOL_TPU_INBLOB=1`` the chunk crosses as one int32 blob each way
    (pipeline/blob.py); by default each plane and each output tensor is
    copied on its own.  Traced: the stages ``dispatch_h2d`` (the uploads)
    and ``dispatch_launch`` (the body's launches), and on a card the chunk's
    interval on the card's timeline (host/tracing.py)."""
    device = torch.device(device)
    with on_device(device):
        if os.environ.get("FQTOOL_TPU_INBLOB", "0") == "1":
            from .blob import dispatch_blob
            return dispatch_blob(body, arrays, aux, device, **kw)
        with stage("dispatch_h2d"):
            host = host_planes(tuple(arrays) + tuple(aux))
            # the chunk's start on the card, just before its first upload
            begun = tracing.card_begin(device)
            planes = upload(host, device)
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
