"""Host <-> device transport shared by the single-end and paired-end
pipelines: upload of a chunk's numpy planes, the handle over a dispatched
chunk, and the conversion of its output dict back to numpy (the JAX
pipelines' host contract)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def to_device(arrays: Sequence[np.ndarray], device) -> tuple:
    """Numpy planes of a ReadPack slice -> tensors on ``device``: uint8 and
    bool planes keep their dtype, integer vectors become int32.  Slices may be
    read-only views, so each is copied into a contiguous array first."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if a.dtype not in (np.uint8, np.bool_):
            a = a.astype(np.int32)
        out.append(torch.as_tensor(a).to(device, non_blocking=True))
    return tuple(out)


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
    waits on an event recorded on the launch stream before copying out."""

    __slots__ = ("_out", "_stream", "_event")

    def __init__(self, out: Dict[str, object], device: torch.device):
        self._out = out
        self._stream = self._event = None
        if device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._event = torch.cuda.Event()
            self._event.record(self._stream)

    def get(self) -> Dict[str, object]:
        if self._event is None:
            return outputs_to_numpy(self._out)
        self._event.synchronize()
        with torch.cuda.stream(self._stream):
            return outputs_to_numpy(self._out)
