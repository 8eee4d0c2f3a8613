"""One-blob transport of a chunk: ``FQTOOL_TPU_INBLOB=1``.

Counterpart of ``fqtool_tpu/pipeline/blob.py``.  The chunk's arguments cross
to the device as ONE int32 blob (``pack_input_blob``, re-split there by
``unblob_inputs`` with views), and the pipeline's outputs come back as ONE
int32 blob (``blobify`` on the device, ``unblobify`` on the host, which
rebuilds the output dict with its NamedTuples and their ``None`` fields).
``_build_input_spec`` and ``pack_input_blob`` are the JAX module's numpy
code, copied.  Off by default: the default path copies each plane and each
output tensor on its own.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..host import tracing
from ..host.tracing import stage
from .device import PipelineResult


def _build_input_spec(rows: int, args, n_aux: int = 0) -> Tuple[Tuple, Tuple[int, int]]:
    """Per-arg (group, offset, padded shape, dtype-name) entries plus section
    lengths, from the UNPADDED argument arrays (row dim padded to ``rows``;
    the trailing ``n_aux`` args keep their own shape -- pack-level side data
    like dictionaries).

    Only the dtypes the pipelines take cross the wire: uint8 matrices
    (seq/qual/enc), int32 vectors (lens/starts), bool vectors (keep).
    """
    spec = []
    off_i32 = off_u8 = 0
    n_row = len(args) - n_aux
    for i, a in enumerate(args):
        shape = ((rows,) + tuple(a.shape[1:])) if i < n_row else tuple(a.shape)
        size = int(np.prod(shape))
        if a.dtype == np.uint8 or a.dtype == np.bool_:
            spec.append(("u8", off_u8, shape, a.dtype.name))
            off_u8 += size
        elif a.dtype == np.int32 or a.dtype == np.int64:
            spec.append(("i32", off_i32, shape, "int32"))
            off_i32 += size
        else:
            raise TypeError(f"unsupported input dtype {a.dtype}")
    return tuple(spec), (off_i32, (off_u8 + 3) // 4)


def pack_input_blob(args, spec, sections) -> np.ndarray:
    """Host side: write every (unpadded) argument into ONE int32 blob at its
    static offset; rows beyond each argument's length stay zero (bool masks
    pad to False).  One host->device transfer then carries the whole
    chunk."""
    i32_len, u8_words = sections
    blob = np.zeros(i32_len + u8_words, np.int32)
    u8 = blob[i32_len:].view(np.uint8)
    for a, (group, off, shape, dtype) in zip(args, spec):
        size = int(np.prod(shape))
        dst = (u8 if group == "u8" else blob)[off : off + size].reshape(shape)
        n = a.shape[0]
        if group == "u8":
            dst[:n] = a.view(np.uint8) if a.dtype == np.bool_ else a
        else:
            dst[:n] = a
    return blob


def unblob_inputs(blob: torch.Tensor, spec, sections) -> list:
    """Device side: re-split the input blob into the argument tensors, each
    a view of the blob (the uint8 section through a dtype view); bool
    arguments become ``!= 0``."""
    i32_len, _ = sections
    u8 = blob[i32_len:].view(torch.uint8)
    args = []
    for group, off, shape, dtype in spec:
        size = int(np.prod(shape))
        if group == "u8":
            x = u8[off : off + size].reshape(shape)
            if dtype == "bool":
                x = x != 0
        else:
            x = blob[off : off + size].reshape(shape)
        args.append(x)
    return args


def _leaves(out: dict) -> list:
    """(key, NamedTuple type or None, field, tensor or None) of every output,
    in key order; a NamedTuple output gives one entry per field."""
    leaves = []
    for key in sorted(out):
        v = out[key]
        if isinstance(v, tuple):
            leaves += [(key, type(v), f, x) for f, x in zip(v._fields, v)]
        else:
            leaves.append((key, None, None, v))
    return leaves


def blobify(out: dict) -> Tuple[torch.Tensor, tuple]:
    """On the device: every output tensor flattened into ONE int32 blob --
    the int32/uint32 section, then int16 pairs, then the uint8/bool section
    padded to 4 bytes, both bitcast -- and the spec ``unblobify`` rebuilds
    the dict from: per leaf (key, type, field, group, offset, shape, numpy
    dtype name), then the section lengths."""
    i32, i16, u8, spec = [], [], [], []
    off = {"i32": 0, "i16": 0, "u8": 0}
    for key, typ, field, x in _leaves(out):
        if x is None:
            spec.append((key, typ, field, None, 0, (), None))
            continue
        flat = x.reshape(-1)
        if x.dtype in (torch.uint8, torch.bool):
            group, part = "u8", u8
            flat = flat.to(torch.uint8)
        elif x.dtype == torch.int16:
            group, part = "i16", i16
        elif x.dtype == torch.uint32:
            group, part = "i32", i32
            flat = flat.view(torch.int32)
        else:
            group, part = "i32", i32
            flat = flat.to(torch.int32)
        spec.append((key, typ, field, group, off[group], tuple(x.shape),
                     str(x.dtype).replace("torch.", "")))
        off[group] += flat.numel()
        part.append(flat)
    dev = next(x.device for _, _, _, x in _leaves(out) if x is not None)
    parts = list(i32)
    if i16:
        h = torch.cat(i16)
        if h.numel() % 2:
            h = torch.nn.functional.pad(h, (0, 1))
        parts.append(h.view(torch.int32))
    if u8:
        b = torch.cat(u8)
        if b.numel() % 4:
            b = torch.nn.functional.pad(b, (0, (-b.numel()) % 4))
        parts.append(b.view(torch.int32))
    blob = torch.cat(parts) if parts else torch.zeros((0,), dtype=torch.int32,
                                                      device=dev)
    return blob, (tuple(spec), (off["i32"], (off["i16"] + 1) // 2))


def unblobify(blob: np.ndarray, spec) -> dict:
    """On the host: the output dict of :func:`blobify`'s spec, every leaf a
    numpy view or copy of the fetched blob."""
    leaves, (i32_len, i16_words) = spec
    i32 = blob[:i32_len]
    i16 = blob[i32_len : i32_len + i16_words].view(np.int16)
    u8 = blob[i32_len + i16_words :].view(np.uint8)
    out, fields = {}, {}
    for key, typ, field, group, off, shape, dtype in leaves:
        arr = None
        if group is not None:
            size = int(np.prod(shape))
            src = {"i32": i32, "i16": i16, "u8": u8}[group]
            arr = src[off : off + size]
            if dtype == "uint32":
                arr = arr.view(np.uint32)
            elif arr.dtype != np.dtype(dtype):
                arr = arr.astype(dtype)
            arr = arr.reshape(shape)
        if typ is None:
            out[key] = arr
        else:
            fields.setdefault(key, (typ, []))[1].append(arr)
    for key, (typ, vals) in fields.items():
        out[key] = typ(*vals)
    return out


class BlobResult(PipelineResult):
    """Handle over a chunk whose outputs wait on the device as one blob."""

    __slots__ = ("_spec",)

    def __init__(self, blob: torch.Tensor, spec, device: torch.device,
                 begun=None):
        super().__init__(blob, device, begun)
        self._spec = spec

    def _fetch(self) -> dict:
        return unblobify(self._out.cpu().numpy(), self._spec)


def dispatch_blob(body, arrays, aux, device: torch.device, **kw) -> BlobResult:
    """:func:`pipeline.device.dispatch` over one blob each way (called with
    ``device`` current)."""
    allargs = tuple(np.asarray(a) for a in tuple(arrays) + tuple(aux))
    rows = allargs[0].shape[0]
    in_spec, in_sections = _build_input_spec(rows, allargs, n_aux=len(aux))
    with stage("dispatch_h2d"):
        host = pack_input_blob(allargs, in_spec, in_sections)
        # the chunk's start on the card's timeline (host/tracing.py)
        begun = tracing.card_begin(device)
        blob = torch.as_tensor(host).to(device, non_blocking=True)
    with stage("dispatch_launch"):
        out = body(*unblob_inputs(blob, in_spec, in_sections), **kw)
        result = BlobResult(*blobify(out), device, begun)
    return result
